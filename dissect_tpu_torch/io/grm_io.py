"""DISSECT-compatible .grm.{dat,ids,snps,diag} binary kernel format.

Parity: Kernel::writeGRM / readGRM (kernel.cpp:893-1009, 1010-1190).
Layout of `.grm.dat`:
  14-byte header: 'G','R','M','\\0', 0x5A, 0x99, version=2, doubles=1,
  sizeof(double)=8, flag (1=normalized, 3=diagonalized), 4 unused bytes.
  Then the packed (n+1) x n matrix in Fortran (column-major) float64
  order: column j holds N[0..j, j] (upper triangle of the normalization
  matrix) followed by kernel[j..n-1, j] (lower triangle incl. diagonal)
  — the packMatrices layout (matrix.cpp:2262-2349).
Diagonalized kernels store the eigenvectors as the (n x n) `.grm.dat`
payload and the eigenvalues in `.grm.diag` raw float64
(kernel.cpp:992-1002).  GCTA's gzipped-text GRMs (`.grm.id` +
`.grm.gz`, kernel.cpp:1198-1370) are read and written too.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np
from dissect_tpu_torch.runtime.log import output_open
from dissect_tpu_torch.runtime.timers import timers

_HEADER_FMT = "<4s2B2B B B 4B"  # 14 bytes


def _header(flag: int) -> bytes:
    return struct.pack(
        _HEADER_FMT, b"GRM\x00", 0x5A, 0x99, 0x2, 0x1, 8, flag, 0, 0, 0, 0
    )


def _check_header(raw: bytes) -> int:
    (magic, m1, m2, version, is_double, dsize, flag, *_rest) = struct.unpack(
        _HEADER_FMT, raw
    )
    if magic != b"GRM\x00" or m1 != 0x5A or m2 != 0x99 or version != 0x2 or is_double != 0x1:
        raise ValueError("not a valid DISSECT GRM file header")
    if dsize != 8:
        raise ValueError("GRM file uses a non-8-byte float type")
    if flag not in (0x1, 0x3):
        raise ValueError("non-normalized GRM files are not supported")
    return flag


def pack_kernel(kernel: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(n, n) kernel + counts -> packed (n+1, n) (matrix.cpp:2262-2349)."""
    n = kernel.shape[0]
    packed = np.empty((n + 1, n), dtype=np.float64)
    iu = np.triu_indices(n)
    il = np.tril_indices(n)
    packed[iu] = counts[iu]
    packed[il[0] + 1, il[1]] = kernel[il]
    return packed


def unpack_kernel(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Packed (n+1, n) -> symmetric (kernel, counts)."""
    n = packed.shape[1]
    iu = np.triu_indices(n)
    il = np.tril_indices(n)
    counts = np.zeros((n, n), dtype=np.float64)
    kernel = np.zeros((n, n), dtype=np.float64)
    counts[iu] = packed[iu]
    counts.T[iu] = packed[iu]
    kernel[il] = packed[il[0] + 1, il[1]]
    kernel.T[il] = packed[il[0] + 1, il[1]]
    return kernel, counts


def write_ids_snps(prefix: str, individual_keys: List[str], snp_names: List[str]):
    with output_open(prefix + ".grm.ids", "w") as fh:
        for key in individual_keys:
            fid, iid = key.split("@", 1)
            fh.write(f"{fid} {iid}\n")
    with output_open(prefix + ".grm.snps", "w") as fh:
        for name in snp_names:
            fh.write(name + "\n")


def read_ids_snps(prefix: str) -> Tuple[List[str], List[str]]:
    keys = []
    with open(prefix + ".grm.ids") as fh:
        for line in fh:
            parts = line.split()
            if parts:
                keys.append(parts[0] + "@" + parts[1])
    snps = []
    with open(prefix + ".grm.snps") as fh:
        for line in fh:
            name = line.strip()
            if name:
                snps.append(name)
    return keys, snps


def write_grm(
    prefix: str,
    kernel: np.ndarray,
    counts: np.ndarray,
    individual_keys: List[str],
    snp_names: List[str],
):
    """Write a normalized GRM in the reference's binary format."""
    write_ids_snps(prefix, individual_keys, snp_names)
    packed = pack_kernel(np.asarray(kernel, dtype=np.float64), np.asarray(counts, dtype=np.float64))
    with output_open(prefix + ".grm.dat", "wb") as fh:
        fh.write(_header(0x1))
        # Fortran order = ScaLAPACK's column-major global layout
        fh.write(packed.T.astype(np.float64).tobytes())


def write_grm_diagonalized(
    prefix: str,
    eigenvalues: np.ndarray,
    eigenvectors: np.ndarray,
    individual_keys: List[str],
    snp_names: List[str],
):
    write_ids_snps(prefix, individual_keys, snp_names)
    with output_open(prefix + ".grm.dat", "wb") as fh:
        fh.write(_header(0x3))
        fh.write(np.asarray(eigenvectors, dtype=np.float64).T.tobytes())
    with output_open(prefix + ".grm.diag", "wb") as fh:
        fh.write(np.asarray(eigenvalues, dtype=np.float64).tobytes())


def read_gcta_grm_gz(prefix: str):
    """Read a GCTA gzipped-text GRM (readGCTAGRM, kernel.cpp:1198-1370):
    `.grm.id` holds FID IID rows; `.grm.gz` holds lower-triangle lines
    'i j n_snps value' (1-based).  Returns kernel + per-pair counts."""
    import gzip

    keys = []
    with open(prefix + ".grm.id") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                keys.append(parts[0] + "@" + parts[1])
    n = len(keys)
    kernel = np.zeros((n, n), dtype=np.float64)
    counts = np.zeros((n, n), dtype=np.float64)
    with gzip.open(prefix + ".grm.gz", "rt") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) < 4:
                continue
            i, j = int(parts[0]) - 1, int(parts[1]) - 1
            counts[i, j] = counts[j, i] = float(parts[2])
            kernel[i, j] = kernel[j, i] = float(parts[3])
    return {
        "individual_keys": keys,
        "snp_names": [],
        "kernel": kernel,
        "counts": counts,
        "diagonalized": False,
    }


def write_gcta_grm_gz(prefix: str, kernel, counts, individual_keys):
    """Write the GCTA gz format (for interop testing)."""
    import gzip

    with output_open(prefix + ".grm.id", "w") as fh:
        for key in individual_keys:
            fid, iid = key.split("@", 1)
            fh.write(f"{fid}\t{iid}\n")
    kernel = np.asarray(kernel)
    counts = np.asarray(counts)
    with output_open(prefix + ".grm.gz", "wb") as raw, gzip.open(raw, "wt") as fh:
        n = len(individual_keys)
        for i in range(n):
            for j in range(i + 1):
                fh.write(f"{i + 1}\t{j + 1}\t{counts[i, j]:g}\t{kernel[i, j]:.8g}\n")


@timers.span("grm_io.read")
def read_grm(prefix: str):
    """Read `.grm.*`; returns a dict with either kernel/counts or eigen data."""
    keys, snps = read_ids_snps(prefix)
    n = len(keys)
    with open(prefix + ".grm.dat", "rb") as fh:
        flag = _check_header(fh.read(14))
        payload = np.frombuffer(fh.read(), dtype=np.float64)
    if flag == 0x1:
        packed = payload.reshape(n, n + 1).T  # column-major -> (n+1, n)
        kernel, counts = unpack_kernel(packed)
        return {
            "individual_keys": keys,
            "snp_names": snps,
            "kernel": kernel,
            "counts": counts,
            "diagonalized": False,
        }
    eigenvectors = payload.reshape(n, n).T
    eigenvalues = np.fromfile(prefix + ".grm.diag", dtype=np.float64)
    return {
        "individual_keys": keys,
        "snp_names": snps,
        "eigenvalues": eigenvalues,
        "eigenvectors": eigenvectors,
        "diagonalized": True,
    }
