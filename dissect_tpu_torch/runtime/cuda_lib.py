"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for sm_90a into its own shared library, loaded with ctypes (no
PyTorch headers, so a build takes seconds).  Libraries are built at
first use into `dissect_tpu_torch/_build/` (listed in .gitignore),
named by a hash of their source, so an edited source is rebuilt and a
stale library is never loaded.  `build_all` starts one nvcc per source
at once.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine class has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("grm_syrk", "syrk_packed", "refit_moments", "bed_decode", "bgen_decode")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> Dict[str, dict]:
    """Compile every library that is not built yet, all nvcc processes
    at once.  Returns {name: {"path", "seconds", "ptxas"}}; raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs: List[tuple] = []
    report: Dict[str, dict] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"path": str(out), "seconds": 0.0, "ptxas": "cached"}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc, time.monotonic()))
    failures = []
    for name, out, tmp, proc, t0 in jobs:
        text, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (rc {proc.returncode}) ---\n{text}")
            continue
        os.replace(tmp, out)
        report[name] = {"path": str(out), "seconds": seconds, "ptxas": text}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def entry(library: str, function: str, n_pointers: int, n_ints: int):
    """The C entry point `function` of csrc/<library>.cu, typed: its
    pointers, then its ints, then the stream; it returns the CUDA error."""
    fn = getattr(load(library), function)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    return fn


def stream_handle(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
