"""PCA — top eigenvectors of a kernel.

Parity: pca.{h,cpp}: eigendecompose the GRM (pdsyev_, pca.cpp:36-67),
keep the top --num-eval eigenvectors, write `.pca.eigenvalues` /
`.pca.eigenvectors` (pca.cpp:69-101).  Eigenvalues are reported in
descending order.  Port of dissect_tpu/pca/pca.py.  Both solves run in
float64 on the kernel's device (linalg/eigen.py); for k << N the
randomized subspace iteration avoids the full O(N^3) solve, and with a
mesh of more than one rank the full solve is the divide-and-conquer
`distributed_eigh` (linalg/dc_eigen.py) on the kernel's rows, whose
row-sharded eigenvectors' top k columns are gathered to rank 0's host
one row block at a time.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dissect_tpu_torch.linalg.eigen import eigh_full, eigh_topk
from dissect_tpu_torch.model.kernels import Kernel
from dissect_tpu_torch.runtime.log import output_open
from dissect_tpu_torch.runtime.mesh import RowShards


@dataclasses.dataclass
class PCA:
    individual_keys: List[str]
    eigenvalues: np.ndarray  # (k,) descending
    # (n, k) columns matching eigenvalues; None on a mesh rank other than
    # rank 0, which alone writes
    eigenvectors: Optional[np.ndarray]
    # the FULL spectrum, descending, when a full solve ran (the
    # reference always has it — pdsyev is full; None for randomized top-k)
    all_eigenvalues: Optional[np.ndarray] = None

    def write(self, prefix: str, precision: int = 8):
        """Write .pca.eigenvalues / .pca.eigenvectors in the reference's
        formats (pca.cpp:85-101): eigenvalues one per line, descending, no
        header — all of them when the full spectrum was computed;
        eigenvectors as 'FID IID v1 v2 ...'."""
        if self.eigenvectors is None:
            return
        evals = self.all_eigenvalues if self.all_eigenvalues is not None else self.eigenvalues
        with output_open(prefix + ".pca.eigenvalues", "w") as fh:
            for w in evals:
                fh.write(f"{w:.{precision}g}\n")
        with output_open(prefix + ".pca.eigenvectors", "w") as fh:
            for i, key in enumerate(self.individual_keys):
                fid, iid = key.split("@", 1)
                row = " ".join(f"{v:.{precision}g}" for v in self.eigenvectors[i])
                fh.write(f"{fid} {iid} {row}\n")


def _columns_on_host(v, cols: np.ndarray) -> Optional[np.ndarray]:
    """Columns `cols` of the eigenvectors as a host array; row-sharded
    ones are gathered to rank 0's host (None on the other ranks)."""
    if isinstance(v, RowShards):
        index = torch.as_tensor(cols.copy(), device=v.device)
        return RowShards(v.local[:, index], v.n, v.ctx).to_root_host()
    return v.cpu().numpy()[:, cols]


def compute_pca(
    kernel: Kernel,
    n_components: int = 20,
    randomized: Optional[bool] = None,
    mesh=None,
) -> PCA:
    """Top-k eigenpairs of a kernel.

    `randomized=None` selects subspace iteration when k < n/8; a
    diagonalized kernel reuses its stored eigendecomposition."""
    n = kernel.n
    k = min(n_components, n)
    keys = list(kernel.individual_keys)
    if kernel.diagonalized:
        w = kernel.eigenvalues.cpu().numpy()
        order = np.argsort(w)[::-1]
        return PCA(
            individual_keys=keys,
            eigenvalues=w[order[:k]],
            eigenvectors=_columns_on_host(kernel.eigenvectors, order[:k]),
            all_eigenvalues=w[order],
        )
    if randomized is None:
        randomized = k * 8 < n
    if randomized:
        w, v = eigh_topk(kernel.dense(), k=k)
        return PCA(individual_keys=keys, eigenvalues=w.cpu().numpy(), eigenvectors=v.cpu().numpy())
    if mesh is not None and mesh.world > 1:
        from dissect_tpu_torch.linalg.dc_eigen import distributed_eigh

        w, v = distributed_eigh(kernel.matrix if kernel.sharded else kernel.dense(), ctx=mesh)
    else:
        w, v = eigh_full(kernel.dense())
    w_all = w.cpu().numpy()[::-1]
    return PCA(
        individual_keys=keys,
        eigenvalues=w_all[:k],
        eigenvectors=_columns_on_host(v, np.arange(n - 1, n - 1 - k, -1)),
        all_eigenvalues=w_all,
    )
