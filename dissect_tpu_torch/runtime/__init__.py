"""Runtime support: device and precision policy, logging, timers, options."""
