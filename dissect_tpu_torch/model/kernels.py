"""Kernels — the GRM.

Parity: kernel.{h,cpp}; port of the GRM pieces of
dissect_tpu/model/kernels.py.  The GRM build normalizes genotypes and
forms kernel = Z^T Z, N = missings^T missings (kernel.cpp:92-109); the
normalized kernel is kernel ./ N (kernel.cpp:382-460).  BED chunks
stream through the packed-triangle accumulator (linalg/syrk.py), kernel
K1 on the card.  The other kernel types (epistatic, interaction,
covariate kernels) come with later slices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

import numpy as np
import torch

from dissect_tpu_torch.io.bed import PlinkData
from dissect_tpu_torch.io.ids import indices_of
from dissect_tpu_torch.linalg.eigen import eigh_full
from dissect_tpu_torch.linalg.syrk import grm_accumulator
from dissect_tpu_torch.runtime.dtypes import GRM_DTYPE


class KernelType(enum.Enum):
    """Parity: kernel.h:35-47."""

    GRM = "grm"
    EPISTATIC_GRM = "epistatic_grm"
    DISCRETE_COVARIATE = "discrete_covariate"
    MULTI_DISCRETE_COVARIATE = "multi_discrete_covariate"
    CONTINUOUS_COVARIATE = "continuous_covariate"
    SQUARED_EXPONENTIAL = "squared_exponential"
    COVARIANCE_MATRIX = "covariance_matrix"
    ENVIRONMENTAL = "environmental"
    INTERACTION = "interaction"
    GCTA_GRM = "gcta_grm"


@dataclasses.dataclass
class Kernel:
    """A named similarity kernel over individuals.

    `matrix` is the normalized kernel (a tensor on the device).  For GRM
    kernels `counts` holds the per-pair shared-SNP counts N and `matrix`
    = raw ./ N.  When `diagonalized`, `eigenvalues`/`eigenvectors`
    replace the dense form (diagonalizeKernel, kernel.cpp:2106-2141).
    """

    name: str
    type: KernelType
    individual_keys: List[str]
    matrix: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None
    snp_names: List[str] = dataclasses.field(default_factory=list)
    normalized: bool = True
    diagonalized: bool = False
    eigenvalues: Optional[torch.Tensor] = None
    eigenvectors: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return len(self.individual_keys)

    def dense(self) -> torch.Tensor:
        """The dense normalized kernel, recovering U diag(w) U^T if
        diagonalized (recoverKernelFromEigenDecomposition, kernel.cpp:2143)."""
        if not self.diagonalized:
            return self.matrix
        u, w = self.eigenvectors, self.eigenvalues
        return (u * w[None, :]) @ u.T

    def diagonalize(self) -> "Kernel":
        """Eigendecompose (float64, on the kernel's device); drop the
        dense kernel and counts (diagonalizeKernel, kernel.cpp:2106-2141)."""
        if self.diagonalized:
            return self
        w, u = eigh_full(self.dense())
        return Kernel(
            name=self.name,
            type=self.type,
            individual_keys=list(self.individual_keys),
            snp_names=list(self.snp_names),
            diagonalized=True,
            eigenvalues=w,
            eigenvectors=u,
        )

    def filter_individuals(self, keep_keys: Sequence[str]) -> "Kernel":
        """Symmetric row+col filter to `keep_keys`, in that order
        (kernel.cpp:1378)."""
        if self.diagonalized:
            raise ValueError("cannot filter a diagonalized kernel; recover first")
        if list(keep_keys) == self.individual_keys:
            return self
        idx = torch.as_tensor(
            indices_of(keep_keys, self.individual_keys), device=self.matrix.device
        )
        pick = lambda a: a.index_select(0, idx).index_select(1, idx)
        return Kernel(
            name=self.name,
            type=self.type,
            individual_keys=list(keep_keys),
            matrix=pick(self.matrix),
            counts=None if self.counts is None else pick(self.counts),
            snp_names=list(self.snp_names),
            normalized=self.normalized,
        )

    def prune(self, cutoff: float) -> "Kernel":
        """Greedily drop individuals until no off-diagonal relatedness
        exceeds `cutoff` (pruneKernel/searchNoHighRelatedIndividuals,
        kernel.cpp:1974-2038): repeatedly remove the individual involved
        in the most over-threshold pairs."""
        k_dev = self.dense()
        off = torch.abs(k_dev - torch.diag(torch.diagonal(k_dev)))
        if not bool(torch.any(off > cutoff)):  # the common case: no fetch
            return self
        k = k_dev.cpu().numpy()
        n = k.shape[0]
        over = np.abs(np.triu(k, 1)) > cutoff
        keep = np.ones(n, dtype=bool)
        while True:
            counts = (over & keep[None, :] & keep[:, None]).sum(0) + (
                over & keep[None, :] & keep[:, None]
            ).sum(1)
            if counts.max(initial=0) == 0:
                break
            keep[int(np.argmax(counts))] = False
        kept = [self.individual_keys[i] for i in range(n) if keep[i]]
        return self.filter_individuals(kept)

    def sanitize(self, min_overlap_ratio: float = 0.1) -> "Kernel":
        """Drop individuals whose pairwise SNP overlap is degenerate
        (sanitizeKernel, kernel.cpp:1993): individuals with any pair
        overlapping fewer than ratio * max(N) are pruned."""
        if self.counts is None:
            return self
        c_dev = self.counts
        cmax = c_dev.max()
        if not bool(torch.any(c_dev < cmax * min_overlap_ratio)):  # no fetch
            return self
        c = c_dev.cpu().numpy()
        threshold = c.max() * min_overlap_ratio
        bad_pairs = c < threshold
        keep = np.ones(self.n, dtype=bool)
        while True:
            active = bad_pairs & keep[None, :] & keep[:, None]
            counts = active.sum(0)
            if counts.max(initial=0) == 0:
                break
            keep[int(np.argmax(counts))] = False
        kept = [self.individual_keys[i] for i in range(self.n) if keep[i]]
        if len(kept) == self.n:
            return self
        return self.filter_individuals(kept)


def grm_from_plink(
    data: PlinkData,
    chunk_size: int = 2048,
    flat_normalization: bool = False,
    name: str = "GRM",
    drop_monomorphic: bool = False,
    device="cuda",
) -> Kernel:
    """Build the float32 GRM from a PLINK fileset via the streaming
    packed-triangle syrk (K1 on the card).

    Parity: Kernel::Kernel(Genotype*) (kernel.cpp:61-125): kernel = Z^T Z
    over standardized genotypes, N = missings^T missings (or the
    constant SNP count under --grm-flat-normalization), then kernel/N.
    Monomorphic SNPs are rejected as in normalizeGenotypes
    (genotype.cpp:915-940).  The ragged last chunk goes to K1 as it is:
    the kernel masks rows past the chunk's end, so the host does not pad
    it with all-missing rows as dissect_tpu does for its static shapes
    (model/kernels.py:309-321).
    """
    stats = data.stats()
    if bool(stats.monomorphic.any()):
        if drop_monomorphic:
            # --keep-zerostd-snps analog: silently drop instead of the
            # reference's .badsnps abort (genotype.cpp:915-940)
            keep = [data.snps[i].name for i in np.nonzero(~stats.monomorphic)[0]]
            data = data.filter(keep_snps=keep)
            stats = data.stats()
        else:
            bad = [data.snps[i].name for i in np.nonzero(stats.monomorphic)[0][:10]]
            raise ValueError(
                "monomorphic SNPs present (filter them first), e.g. " + ", ".join(bad)
            )
    mean = stats.mean
    inv_std = 1.0 / stats.std
    acc = grm_accumulator(data.n_individuals, device=device)
    for start, stop, chunk in data.iter_chunks(chunk_size):
        acc.update(chunk, mean[start:stop], inv_std[start:stop])
    raw, counts = acc.finalize()
    if flat_normalization:
        counts = torch.full_like(counts, float(data.n_snps))
    normalized = raw / torch.where(counts == 0, torch.ones_like(counts), counts)
    return Kernel(
        name=name,
        type=KernelType.GRM,
        individual_keys=data.individual_keys,
        matrix=normalized.to(GRM_DTYPE),
        counts=counts,
        snp_names=data.snp_names,
    )
