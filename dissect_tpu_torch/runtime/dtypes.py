"""Precision policy of the port.

JAX runs the tests in float64 (`jax_enable_x64`) and production on the
TPU in float32.  The port keeps the same two policies, chosen by the
device a computation runs on:

  * parity: float64 on the CPU, where the tests hold the port against
    the JAX package;
  * bulk: float32 on the card, the JAX production path
    (dissect_tpu/gwas/mlm.py:402-415).

Two computations do not follow the bulk dtype on either device: the GRM
accumulates in float32 (`grm_from_plink` fixes it,
dissect_tpu/model/kernels.py:271,306), and the O(n) diagonal REML fit and
the kernel eigendecomposition run in float64 wherever they run.

TF32 would keep about three decimal digits of a float32 product and
cannot meet the GRM's rtol 1e-6, so it is switched off at start-up.
"""

from __future__ import annotations

import torch

GRM_DTYPE = torch.float32


def configure_precision() -> None:
    """Full-float32 products on the card: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be disabled")


def bulk_dtype(device) -> torch.dtype:
    """float32 on the card, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64
