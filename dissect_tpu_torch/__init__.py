"""dissect_tpu_torch — the PyTorch/CUDA port of dissect_tpu for NVIDIA Hopper.

The JAX package `dissect_tpu` stays the reference; this package mirrors
its module paths (`dissect_tpu/gwas/mlm.py` <-> `dissect_tpu_torch/gwas/mlm.py`)
and its CLI (`python -m dissect_tpu_torch ...`), and imports nothing
from it.  The TPU's Pallas kernels on the ported path are hand-written
CUDA C++ for sm_90a under `csrc/`, each with a plain PyTorch version
beside its wrapper.

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`, or `DISSECT_TPU_TORCH_DEVICE=cpu` for the CLI).
"""
