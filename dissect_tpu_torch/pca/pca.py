"""PCA — top eigenvectors of a kernel.

Parity: pca.{h,cpp}: eigendecompose the GRM (pdsyev_, pca.cpp:36-67),
keep the top --num-eval eigenvectors, write `.pca.eigenvalues` /
`.pca.eigenvectors` (pca.cpp:69-101).  Eigenvalues are reported in
descending order.  Port of dissect_tpu/pca/pca.py.  Both solves run in
float64 on the kernel's device (linalg/eigen.py); for k << N the
randomized subspace iteration avoids the full O(N^3) solve, and with a
mesh of more than one rank the full solve is the divide-and-conquer
`distributed_eigh` (linalg/dc_eigen.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from dissect_tpu_torch.linalg.eigen import eigh_full, eigh_topk
from dissect_tpu_torch.model.kernels import Kernel
from dissect_tpu_torch.runtime.log import output_open


@dataclasses.dataclass
class PCA:
    individual_keys: List[str]
    eigenvalues: np.ndarray  # (k,) descending
    eigenvectors: np.ndarray  # (n, k) columns matching eigenvalues
    # the FULL spectrum, descending, when a full solve ran (the
    # reference always has it — pdsyev is full; None for randomized top-k)
    all_eigenvalues: Optional[np.ndarray] = None

    def write(self, prefix: str, precision: int = 8):
        """Write .pca.eigenvalues / .pca.eigenvectors in the reference's
        formats (pca.cpp:85-101): eigenvalues one per line, descending, no
        header — all of them when the full spectrum was computed;
        eigenvectors as 'FID IID v1 v2 ...'."""
        evals = self.all_eigenvalues if self.all_eigenvalues is not None else self.eigenvalues
        with output_open(prefix + ".pca.eigenvalues", "w") as fh:
            for w in evals:
                fh.write(f"{w:.{precision}g}\n")
        with output_open(prefix + ".pca.eigenvectors", "w") as fh:
            for i, key in enumerate(self.individual_keys):
                fid, iid = key.split("@", 1)
                row = " ".join(f"{v:.{precision}g}" for v in self.eigenvectors[i])
                fh.write(f"{fid} {iid} {row}\n")


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
        v = kernel.eigenvectors.cpu().numpy()
        order = np.argsort(w)[::-1]
        return PCA(
            individual_keys=keys,
            eigenvalues=w[order[:k]],
            eigenvectors=v[:, order[:k]],
            all_eigenvalues=w[order],
        )
    if randomized is None:
        randomized = k * 8 < n
    if randomized:
        w, v = eigh_topk(kernel.dense(), k=k)
        return PCA(individual_keys=keys, eigenvalues=w.cpu().numpy(), eigenvectors=v.cpu().numpy())
    if mesh is not None and mesh.world > 1:
        from dissect_tpu_torch.linalg.dc_eigen import distributed_eigh

        w, v = distributed_eigh(kernel.dense(), ctx=mesh)
    else:
        w, v = eigh_full(kernel.dense())
    w_all = w.cpu().numpy()[::-1]
    return PCA(
        individual_keys=keys,
        eigenvalues=w_all[:k],
        eigenvectors=v.cpu().numpy()[:, ::-1][:, :k],
        all_eigenvalues=w_all,
    )
