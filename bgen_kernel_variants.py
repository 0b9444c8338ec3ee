"""Time versions of K6 and K7 (csrc/bgen_decode.cu) against each other on one card.

    python3 bgen_kernel_variants.py NAME=SOURCE ...    # from the repository root

Each SOURCE is a version of dissect_tpu_torch/csrc/bgen_decode.cu with
the same C entry points (a parent commit's, from `git show
<commit>:dissect_tpu_torch/csrc/bgen_decode.cu`, or a copy with changed
constants).  Every version, and this tree's kernel through its wrapper
("tree"), decodes the same inputs at the shapes chip_smoke.py times: the
BGEN path's batch (1,024 blocks, N = 10,000), its last batch (424 blocks)
and UK Biobank's width (64 blocks, N = 487,409), layout 2 (8-bit,
unphased) and layout 1.  Each result is held bit for bit against the
plain version; a version that disagrees is reported (`same`: false), not
timed out.  Times: held (chip_smoke.time_ms, twice) and with the L2
cache emptied before each call (chip_smoke.time_cold_ms).  Prints one
JSON line per kernel and shape, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
SHAPES = (("batch", 1024, 10_000), ("last_batch", 424, 10_000), ("ukb", 64, 487_409))


def build(name, source, build_dir):
    """nvcc `source` into build_dir/lib<name>.so; prints its registers and spills."""
    from dissect_tpu_torch.runtime import cuda_lib

    out = build_dir / f"lib{name}.so"
    proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name}:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(out))


def entry(lib, function):
    """The C entry point as the wrapper calls it, into a given out and status."""
    fn = getattr(lib, function)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

    def call(buf, offsets, lengths, n, out, status):
        rc = fn(buf.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                status.data_ptr(), offsets.shape[0], n, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{function}: CUDA error {rc}")

    return call


def main(argv):
    if not torch.cuda.is_available():
        print("bgen_kernel_variants: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from dissect_tpu_torch.io import genotype_kernels as gk
    from dissect_tpu_torch.runtime import cuda_lib

    build_dir = cuda_lib.BUILD_DIR / "variants"
    build_dir.mkdir(parents=True, exist_ok=True)
    cuda_lib.build_all(["bgen_decode"])
    libs = {name: build(name, Path(source), build_dir)
            for name, source in (arg.split("=", 1) for arg in argv)}
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rng = np.random.default_rng(cs.SEED + 9)
    for kernel, batch in (("bgen_decode_l2", cs._main_l2_batch),
                          ("bgen_decode_l1", cs._main_l1_batch)):
        wrapper, plain = getattr(gk, kernel), getattr(gk, "plain_" + kernel)
        for label, k, n in SHAPES:
            blocks, _ = batch(rng, k, n)
            buf, offsets, lengths = cs._blocks_on_card(blocks, device)
            ref, _ = plain(buf, offsets, lengths, n)
            out = torch.empty((k, n), device=device)
            status = torch.empty((k,), dtype=torch.int32, device=device)
            calls = {"tree": lambda: wrapper(buf, offsets, lengths, n, out=out)}
            for name, lib in libs.items():
                call = entry(lib, kernel)
                calls[name] = lambda call=call: call(buf, offsets, lengths, n, out, status)
            row = {"kernel": kernel, "shape": label, "blocks": k, "n": n,
                   "bound_ms": cs.bgen_bound(buf.numel(), k, n)[0]}
            for name, fn in calls.items():
                out.fill_(5.0)
                fn()
                torch.cuda.synchronize()
                row[name] = {"same": cs._same_bits(out, ref),
                             "ms": cs.time_ms(fn, iters=20, held=True),
                             "ms_again": cs.time_ms(fn, iters=20, held=True),
                             "cold_ms": cs.time_cold_ms(fn)}
            print(json.dumps(row), flush=True)
            del buf, ref, out
            torch.cuda.empty_cache()
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
