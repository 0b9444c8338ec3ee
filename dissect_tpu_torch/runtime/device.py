"""Which device the CLI runs on.

The JAX CLI takes its platform override from DISSECT_TPU_PLATFORM
(dissect_tpu/runtime/distributed.py:95-109); the port reads
DISSECT_TPU_TORCH_DEVICE.  Without it the CLI runs on the CUDA card
(card LOCAL_RANK under a torchrun launch: one card per rank), and with
no card it stops: it never falls back to the CPU on its own.  With it,
every rank of a launch uses the named device, which is how ranks share
one card or run on the CPU.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "DISSECT_TPU_TORCH_DEVICE"


class DeviceUnavailable(RuntimeError):
    """No CUDA device, and the CPU was not asked for."""


def cli_device() -> torch.device:
    """The device named by DISSECT_TPU_TORCH_DEVICE, else card LOCAL_RANK
    (card 0 outside a torchrun launch)."""
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
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if local >= torch.cuda.device_count():
        raise DeviceUnavailable(
            f"LOCAL_RANK {local} but only {torch.cuda.device_count()} CUDA device(s) "
            f"are visible; set {DEVICE_ENV}=cuda:0 to run every rank on one card"
        )
    return torch.device("cuda", local)
