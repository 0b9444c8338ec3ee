"""python -m dissect_tpu_torch — the CLI entry point (main.cpp parity).

Runs on the CUDA card; with no card visible and no
DISSECT_TPU_TORCH_DEVICE=cpu it exits 1 with a message instead of
falling back to the CPU."""

import sys

from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.runtime.device import DeviceUnavailable

if __name__ == "__main__":
    try:
        main()
    except DeviceUnavailable as exc:
        print(f"dissect_tpu_torch: {exc}", file=sys.stderr)
        sys.exit(1)
