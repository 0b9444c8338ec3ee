"""Which device the CLI runs on.

The JAX CLI takes its platform override from DISSECT_TPU_PLATFORM
(dissect_tpu/runtime/distributed.py:95-109); the port reads
DISSECT_TPU_TORCH_DEVICE.  Without it the CLI runs on the CUDA card,
and with no card it stops: it never falls back to the CPU on its own.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "DISSECT_TPU_TORCH_DEVICE"


class DeviceUnavailable(RuntimeError):
    """No CUDA device, and the CPU was not asked for."""


def cli_device() -> torch.device:
    """The device named by DISSECT_TPU_TORCH_DEVICE, else the first card."""
    requested = os.environ.get(DEVICE_ENV, "").strip()
    if requested:
        device = torch.device(requested)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise DeviceUnavailable(f"{DEVICE_ENV}={requested} but no CUDA device is visible")
        return device
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"no CUDA device is visible; set {DEVICE_ENV}=cpu to run on the CPU"
        )
    return torch.device("cuda", 0)


def check_single_device(mesh: str) -> None:
    """--mesh: the port runs on one device until the multi-GPU slice
    (ROADMAP.md, queue 1 item 9)."""
    if mesh not in ("auto", "none", "1", "1x1"):
        raise NotImplementedError(
            f"--mesh {mesh}: multi-device runs are not ported yet "
            "(ROADMAP.md queue 1, item 9)"
        )
