"""Kernels — GRM and relatives.

Parity: kernel.{h,cpp}; port of dissect_tpu/model/kernels.py.  The GRM
build normalizes genotypes and forms kernel = Z^T Z, N = missings^T
missings (kernel.cpp:92-109); the normalized kernel is kernel ./ N
(kernel.cpp:382-460).  Genotype chunks stream through the
packed-triangle accumulator (linalg/syrk.py): PLINK hard calls through
kernel K1 on the card, BGEN imputed dosages through K2.  Beside the GRM:
the epistatic kernel (K .* K, kernel.cpp:279-316), the interaction
kernel (kernel.cpp:176-247), GRM addition (kernel.cpp:1705), and the
discrete / multi-discrete covariate, couples and squared-exponential
kernels.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from dissect_tpu_torch.io.bed import PlinkData
from dissect_tpu_torch.io.bgen import BgenData
from dissect_tpu_torch.io.ids import indices_of
from dissect_tpu_torch.linalg.eigen import eigh_full
from dissect_tpu_torch.linalg.syrk import grm_accumulator
from dissect_tpu_torch.runtime.dtypes import GRM_DTYPE
from dissect_tpu_torch.runtime.mesh import RowShards
from dissect_tpu_torch.runtime.timers import timers


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
    A multi-rank GRM holds both as RowShards (`sharded`): the
    transforms below keep them row-sharded where they can, and `dense`
    and `whole` gather them.  A kernel diagonalized on more than one
    rank holds its eigenvectors as RowShards too.
    """

    name: str
    type: KernelType
    individual_keys: List[str]
    matrix: Optional[Union[torch.Tensor, RowShards]] = None
    counts: Optional[Union[torch.Tensor, RowShards]] = None
    snp_names: List[str] = dataclasses.field(default_factory=list)
    normalized: bool = True
    diagonalized: bool = False
    eigenvalues: Optional[torch.Tensor] = None
    eigenvectors: Optional[Union[torch.Tensor, RowShards]] = None

    @property
    def n(self) -> int:
        return len(self.individual_keys)

    @property
    def sharded(self) -> bool:
        return isinstance(self.matrix, RowShards)

    def dense(self) -> torch.Tensor:
        """The dense normalized kernel, recovering U diag(w) U^T if
        diagonalized (recoverKernelFromEigenDecomposition, kernel.cpp:2143);
        a row-sharded kernel is gathered whole."""
        if self.sharded:
            return self.matrix.whole()
        if not self.diagonalized:
            return self.matrix
        u, w = self.whole().eigenvectors, self.eigenvalues
        return (u * w[None, :]) @ u.T

    def whole(self) -> "Kernel":
        """This kernel with its matrix, counts and eigenvectors whole on
        every rank."""
        gather = lambda t: t.whole() if isinstance(t, RowShards) else t
        if not (self.sharded or isinstance(self.eigenvectors, RowShards)):
            return self
        return dataclasses.replace(
            self, matrix=gather(self.matrix), counts=gather(self.counts),
            eigenvectors=gather(self.eigenvectors),
        )

    # --- transforms ----------------------------------------------------------
    def epistatic(self) -> "Kernel":
        """K .* K epistasis kernel (kernel.cpp:279-316).  It has no SNP
        counts: `counts` is None."""
        square = lambda t: t * t
        k = self.matrix.map(square) if self.sharded else square(self.dense())
        return Kernel(
            name=self.name + "xE",
            type=KernelType.EPISTATIC_GRM,
            individual_keys=list(self.individual_keys),
            matrix=k,
            snp_names=list(self.snp_names),
        )

    def interaction(self, other: "Kernel", name: Optional[str] = None) -> "Kernel":
        """Elementwise product on the id overlap (kernel.cpp:176-247)."""
        common = [k for k in self.individual_keys if k in set(other.individual_keys)]
        a = self.filter_individuals(common)
        b = other.filter_individuals(common)
        return Kernel(
            name=name or (self.name + "x" + other.name),
            type=KernelType.INTERACTION,
            individual_keys=common,
            matrix=a.dense() * b.dense(),
        )

    def slice_asymmetric(self, row_keys: Sequence[str], col_keys: Sequence[str]) -> torch.Tensor:
        """K[rows, cols] asymmetric sub-block (the asymmetric individual
        filter, kernel.cpp:1493) — the cross-trait kernel block for
        differing per-trait individual sets."""
        k = self.dense()
        index = lambda keys: torch.as_tensor(
            indices_of(keys, self.individual_keys), dtype=torch.long, device=k.device
        )
        ri, ci = index(row_keys), index(col_keys)
        return k.index_select(0, ri).index_select(1, ci)

    @timers.span("eigen.diagonalize")
    def diagonalize(self, mesh=None) -> "Kernel":
        """Eigendecompose (float64, on the kernel's device); drop the
        dense kernel and counts (diagonalizeKernel, kernel.cpp:2106-2141).

        With a MeshContext of more than one rank, the spectral
        divide-and-conquer solver (linalg/dc_eigen.py) splits the O(N^3)
        work over the ranks, taking a row-sharded kernel's rows as they
        are and giving the eigenvectors back as RowShards; a one-rank
        mesh keeps the local solve, as in
        dissect_tpu/model/kernels.py:110-130."""
        if self.diagonalized:
            return self
        if mesh is not None and mesh.world > 1:
            from dissect_tpu_torch.linalg.dc_eigen import distributed_eigh

            w, u = distributed_eigh(self.matrix if self.sharded else self.dense(), ctx=mesh)
        else:
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
            indices_of(keep_keys, self.individual_keys), dtype=torch.long,
            device=self.matrix.device,
        )
        if self.sharded:
            # each rank fetches its rows of the filtered matrix
            r0, r1 = self.matrix.ctx.local_rows(len(idx))
            pick = lambda a: RowShards(a.take([(idx[r0:r1], idx)])[0], len(idx), a.ctx)
        else:
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
        if self.sharded:
            m = self.matrix
            r0, r1 = m.ctx.local_rows(m.n)
            rows = torch.arange(r1 - r0, device=m.device)
            off = torch.abs(m.local).index_put((rows, rows + r0), torch.zeros((), dtype=m.dtype, device=m.device))
            over = m.ctx.all_reduce(torch.sum(off > cutoff, dtype=torch.float64).reshape(1))
            return self if float(over[0]) == 0 else self.whole().prune(cutoff)
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

    @timers.span("grm.sanitize")
    def sanitize(self, min_overlap_ratio: float = 0.1) -> "Kernel":
        """Drop individuals whose pairwise SNP overlap is degenerate
        (sanitizeKernel, kernel.cpp:1993): individuals with any pair
        overlapping fewer than ratio * max(N) are pruned."""
        if self.counts is None:
            return self
        if self.sharded:
            c, ctx = self.counts.local, self.counts.ctx
            cmax = ctx.all_gather(c.max().reshape(1) if c.numel() else c.new_zeros(1)).max()
            low = ctx.all_reduce(torch.sum(c < cmax * min_overlap_ratio, dtype=torch.float64).reshape(1))
            return self if float(low[0]) == 0 else self.whole().sanitize(min_overlap_ratio)
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

    def keep_with_relatedness_outside(self, low: float, high: float) -> "Kernel":
        """Keep only individuals participating in at least one pair whose
        relatedness falls OUTSIDE [low, high]
        (keepWithRelatednessOutside, kernel.cpp:2039-2070) — used to
        focus analyses on informative related/unrelated pairs."""
        k = self.dense().cpu().numpy()
        n = k.shape[0]
        off = k.copy()
        np.fill_diagonal(off, (low + high) / 2.0)  # diagonal never triggers
        outside = (off < low) | (off > high)
        keep = outside.any(axis=1)
        kept = [self.individual_keys[i] for i in range(n) if keep[i]]
        if len(kept) == n:
            return self
        return self.filter_individuals(kept)

    # --- combination ---------------------------------------------------------
    def add(self, other: "Kernel", subtract: bool = False) -> "Kernel":
        """Denormalize -> add/subtract raw kernels and counts -> renormalize
        (addGRMs, kernel.cpp:1705).  Requires identical individuals."""
        if self.individual_keys != other.individual_keys:
            raise ValueError("addGRMs requires identical individual sets")
        if self.counts is None or other.counts is None:
            raise ValueError("addGRMs requires counts (N) matrices")
        if self.sharded or other.sharded:
            return self.whole().add(other.whole(), subtract)
        sign = -1.0 if subtract else 1.0
        raw = self.matrix * self.counts + sign * other.matrix * other.counts
        counts = self.counts + sign * other.counts
        # the set is built once; the JAX package rebuilds it for every SNP
        # of self (dissect_tpu/model/kernels.py:254), which is quadratic
        # in the SNP count
        removed = set(other.snp_names)
        snps = (
            [s for s in self.snp_names if s not in removed]
            if subtract
            else self.snp_names + other.snp_names
        )
        return Kernel(
            name=self.name,
            type=self.type,
            individual_keys=list(self.individual_keys),
            matrix=raw / torch.where(counts == 0, torch.ones_like(counts), counts),
            counts=counts,
            snp_names=snps,
        )


def grm_from_plink(
    data: Union[PlinkData, BgenData],
    chunk_size: int = 2048,
    flat_normalization: bool = False,
    name: str = "GRM",
    drop_monomorphic: bool = False,
    device="cuda",
) -> Kernel:
    """Build the float32 GRM from a PLINK fileset (int8 hard calls, K1 on
    the card) or BGEN data (float imputed dosages, K2 on the card) via the
    streaming packed-triangle syrk.

    Each chunk is decoded on the data's device (`decode_rows`: K4 for
    PLINK data; BGEN dosages are resident there) and goes to the
    accumulator with no host round trip; the SNP statistics come from
    K5's counts (PLINK) or the resident dosages (BGEN).

    Parity: Kernel::Kernel(Genotype*) (kernel.cpp:61-125): kernel = Z^T Z
    over standardized genotypes, N = missings^T missings (or the
    constant SNP count under --grm-flat-normalization), then kernel/N.
    Monomorphic SNPs are rejected as in normalizeGenotypes
    (genotype.cpp:915-940).  The ragged last chunk goes to K1 or K2 as it
    is: both kernels mask rows past the chunk's end, so the host does not
    pad it with all-missing rows as dissect_tpu does for its static
    shapes (model/kernels.py:309-321).

    Spans (runtime/timers.py): grm.stats (the statistics, the mean and
    1/std on the host), grm.accumulate (K4 and K1 over the chunks),
    grm.normalize.
    """
    with timers.span("grm.stats"):
        stats = data.stats()
        if bool(stats.monomorphic.any()):
            names = data.snp_names
            if drop_monomorphic:
                # --keep-zerostd-snps analog: silently drop instead of the
                # reference's .badsnps abort (genotype.cpp:915-940)
                keep = [names[i] for i in np.nonzero(~stats.monomorphic)[0]]
                data = data.filter(keep_snps=keep)
                stats = data.stats()
            else:
                bad = [names[i] for i in np.nonzero(stats.monomorphic)[0][:10]]
                raise ValueError(
                    "monomorphic SNPs present (filter them first), e.g. " + ", ".join(bad)
                )
        mean = stats.mean
        inv_std = 1.0 / stats.std
    with timers.span("grm.accumulate"):
        acc = grm_accumulator(data.n_individuals, device=device)
        for start in range(0, data.n_snps, chunk_size):
            stop = min(start + chunk_size, data.n_snps)
            acc.update(data.decode_rows(start, stop), mean[start:stop], inv_std[start:stop])
        raw, counts = acc.finalize()
    with timers.span("grm.normalize"):
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


def kernel_from_discrete(
    name: str, keys: List[str], categories: Sequence[str], device="cuda"
) -> Kernel:
    """1 where two individuals share a category (createKernelFromDiscreteCovariates)."""
    cats = np.asarray(categories)
    same = (cats[:, None] == cats[None, :]).astype(np.float32)
    return Kernel(
        name=name,
        type=KernelType.DISCRETE_COVARIATE,
        individual_keys=list(keys),
        matrix=torch.as_tensor(same, device=device),
    )


def couples_kernel(kernel: Kernel, couples: Dict[str, str]) -> Optional[Kernel]:
    """Indirect-effects kernel: relatedness of each individual's partner,
    relabeled with the original ids — K'[i, j] = K[partner(i), partner(j)]
    (introduceResortedGRMsByCouples, auxiliar.cpp:961-1040).

    `couples` maps FID@IID -> partner FID@IID.  Individuals without a
    partner present in the kernel are dropped; returns None when fewer
    than a quarter of the kernel's individuals survive
    (auxiliar.cpp:998-1002).
    """
    present = set(kernel.individual_keys)
    kept_keys: List[str] = []
    partner_keys: List[str] = []
    for key in kernel.individual_keys:
        partner = couples.get(key)
        if partner is None or partner not in present:
            continue
        kept_keys.append(key)
        partner_keys.append(partner)
    if len(kept_keys) * 4 <= kernel.n:
        return None
    resorted = kernel.filter_individuals(partner_keys)
    return Kernel(
        name="coup" + kernel.name,
        type=kernel.type,
        individual_keys=kept_keys,  # relabel with the original ids
        matrix=resorted.matrix,
        counts=resorted.counts,
        snp_names=list(kernel.snp_names),
    )


def kernel_from_multi_discrete(
    name: str, keys: List[str], category_sets: Sequence[Sequence[str]], device="cuda"
) -> Kernel:
    """K[i,j] = |cats_i ∩ cats_j| / sqrt(|cats_i| |cats_j|)
    (createKernelFromMultipleDiscreteCovariates, kernel.cpp:578-737):
    the normalized-indicator Gram matrix Z_norm Z_norm^T, formed on the
    host as the reference forms it."""
    cats = sorted({c for s in category_sets for c in s})
    index = {c: i for i, c in enumerate(cats)}
    z = np.zeros((len(keys), len(cats)), dtype=np.float32)
    for i, s in enumerate(category_sets):
        for c in set(s):
            z[i, index[c]] = 1.0
    norms = np.sqrt(np.maximum(z.sum(axis=1), 1.0))
    zn = z / norms[:, None]
    return Kernel(
        name=name,
        type=KernelType.MULTI_DISCRETE_COVARIATE,
        individual_keys=list(keys),
        matrix=torch.as_tensor(zn @ zn.T, device=device),
        snp_names=cats,
    )


def kernel_squared_exponential(
    name: str,
    keys: List[str],
    coords: np.ndarray,
    length_scale: Optional[float] = None,
    device="cuda",
) -> Kernel:
    """Squared-exponential kernel from coordinates (kernel.cpp:742+).

    With `length_scale=None` (the REML path) the kernel stores the
    SQUARED DISTANCES D and the covariance model evaluates
    exp(-alpha0 * D) with alpha0 a fitted ParameterAttributes::parameter
    (applyExponentialOperator, covariancematrix.cpp:805).  With an
    explicit length scale the exponential is materialized directly.
    """
    sq = torch.as_tensor(((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1), device=device)
    if length_scale is None:
        return Kernel(
            name=name,
            type=KernelType.SQUARED_EXPONENTIAL,
            individual_keys=list(keys),
            matrix=sq,
        )
    return Kernel(
        name=name,
        type=KernelType.SQUARED_EXPONENTIAL,
        individual_keys=list(keys),
        matrix=torch.exp(-0.5 * sq / (length_scale**2)),
    )
