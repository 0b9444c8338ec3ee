"""Grouped and recursive GWAS — joint per-group fits with F-tests.

Parity: GWAS::computeGroupedGWAS (gwas.cpp:314-478): each SNP group is
fit jointly as [X | G_S'] with OLS; group significance is the F-test
against the covariates-only reduced model (computeGroupSignificance,
gwas.cpp:916-967): SSR = b'X'y_full - b'X'y_reduced, F = (SSR/h)/MSE,
p = F_sf(h, n - p, F).  Linearly dependent SNP columns are dropped via
QR pivots before refitting (gwas.cpp:404-438, matrix.cpp:3501+).  With a
mixed-model covariance each group is an ML refit in its eigenbasis with
the chi2 LRT (gwas.cpp:787-914, 940-957).  Group variance = var(G_S b_S)
and per-individual group effects (computeGroupVariance,
gwas.cpp:970-1034).  Correlated-SNP flagging drops the less significant
of highly correlated pairs (getLessSignificantCorrelatedSNPs,
gwas.cpp:1156).  Recursive GWAS (computeRecursiveGWAS, gwas.cpp:239-284)
iterates group-fit -> keep significant -> regroup to a fixed point.

Port of dissect_tpu/gwas/grouped.py.  Groups are bucketed by size, and
each bucket's joint solves run batched on the device, in float64.  One
deliberate departure: the JAX package forms the whole M x N float64
centred genotype matrix on the host and copies it again per bucket
(dissect_tpu/analysis/dispatcher.py:830-831, grouped.py:116, :187).
Here the raw dosages are decoded on the device once (`CenteredRows`), each batch of
groups is centred on the device, rotated there into the covariance
eigenbasis for the ML branch, and a bucket runs in batches of groups
whose size bounds the device memory.  The numbers are the same.

With a MeshContext (`mesh_ctx`, --parallel-gwas) each rank filters and
fits a contiguous share of every size bucket's groups, as JAX shards a
bucket's group axis over the mesh (dissect_tpu/gwas/grouped.py:171-181),
and the per-group results are all-gathered (the effects as float64 row
blocks; the gathers are timed as the GatherGroups phase), so every rank
returns the single-device results in their order.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from dissect_tpu_torch.gwas.mlm import _host, _ml_fit_diagonal
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.linalg.qr import dependent_columns_batched
from dissect_tpu_torch.runtime.stats import chi2_sf, f_sf, t_sf
from dissect_tpu_torch.runtime.timers import timers

# bytes of one batch's (groups, n, covariates + SNPs) float64 design;
# the fits hold a few such tensors at once
GROUP_BATCH_BYTES = 1 << 30


def centered_genotypes(dosage: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Missing-zeroed mean-centered rows of an (m, N) chunk, for both hard
    calls (int8, -1 missing) and imputed dosages (float, NaN missing), in
    float64 on the chunk's device.  Centering on the device keeps the host
    at the raw chunk instead of M x N float64."""
    if dosage.is_floating_point():
        observed = torch.isfinite(dosage)
    else:
        observed = dosage >= 0
    centered = dosage.to(torch.float64) - mean.to(torch.float64)[:, None]
    return torch.where(observed, centered, torch.zeros_like(centered))


class CenteredRows:
    """Genotype rows on a device, handed out centred in float64 by index.

    With `mean`, `dosage` holds raw rows (int8 hard calls with -1
    missing, or float dosages with NaN missing), centred per request;
    without it, rows that are centred already."""

    def __init__(self, dosage: torch.Tensor, mean: Optional[torch.Tensor] = None):
        self.dosage = dosage
        self.mean = mean

    @classmethod
    def from_data(cls, data, device) -> "CenteredRows":
        """All of a PLINK or BGEN dataset's rows in their raw dtype, decoded
        on the data's device (`decode_rows`: K4 for PLINK data), with the
        SNP means."""
        dosage = data.decode_rows(0, data.n_snps).to(device)
        return cls(dosage, torch.as_tensor(data.stats().mean, device=device))

    @property
    def device(self) -> torch.device:
        return self.dosage.device

    @property
    def n_individuals(self) -> int:
        return self.dosage.shape[1]

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows idx (any shape) as (*idx.shape, n) float64."""
        flat = idx.reshape(-1)
        rows = self.dosage[flat]
        if self.mean is None:
            rows = rows.to(torch.float64)
        else:
            rows = centered_genotypes(rows, self.mean[flat])
        return rows.reshape(*idx.shape, self.n_individuals)


def _as_rows(genotypes) -> CenteredRows:
    if isinstance(genotypes, CenteredRows):
        return genotypes
    g = genotypes if isinstance(genotypes, torch.Tensor) else torch.as_tensor(np.asarray(genotypes))
    return CenteredRows(g.to(torch.float64))


def _share(items: Sequence, ctx) -> Sequence:
    """This rank's contiguous share of `items` (all of them without a
    mesh): ceil-sized shares, the last ranks' short or empty."""
    if ctx is None:
        return items
    lo, hi = ctx.local_rows(len(items))
    return items[lo:hi]


def _joined(local: dict, ctx) -> dict:
    """Every rank's entries of `local`, all-gathered and merged."""
    if ctx is None:
        return local
    merged: dict = {}
    with timers.phase("GatherGroups"):
        for part in ctx.all_gather_object(local):
            merged.update(part)
    return merged


def _batches(items: Sequence, n: int, width: int, group_batch: Optional[int]):
    """Consecutive slices of `items`, each small enough that its
    (groups, n, width) float64 design stays under GROUP_BATCH_BYTES."""
    size = group_batch or max(1, GROUP_BATCH_BYTES // (8 * n * width))
    for start in range(0, len(items), size):
        yield items[start : start + size]


@dataclasses.dataclass
class GroupResult:
    group: str
    snp_names: List[str]
    beta: np.ndarray  # (c + s,) covariates then SNPs
    se: np.ndarray
    p: np.ndarray
    f_statistic: float
    f_p_value: float
    group_variance: float
    dropped_snps: List[str]
    success: bool = True


def grouped_gwas(
    genotypes,
    snp_names: Sequence[str],
    grouping: "OrderedDict[str, List[str]]",
    y,
    x,
    significance_threshold: float = 5e-8,
    correlation_threshold: float = 0.99,
    compute_effects: bool = False,
    covariance=None,
    ml_iterations: int = 15,
    group_batch: Optional[int] = None,
    mesh_ctx=None,
) -> Tuple[Dict[str, GroupResult], Optional[LabeledMatrix]]:
    """Joint fit per SNP group, batched by group size.

    `genotypes`: a `CenteredRows`, or (M, n) centred rows (an array is
    taken to the CPU).  Without `covariance`: OLS with the F-test
    GROUPPV.  With `covariance` = (eigenvalues, eigenvectors, theta0) of
    the mixed-model kernel: per-group ML refits in the eigenbasis with
    the chi2 likelihood-ratio GROUPPV against the covariates-only ML fit
    (computeGroupSignificance's MLModelType branch, gwas.cpp:940-957).
    `group_batch` caps the groups solved at once (default: by
    GROUP_BATCH_BYTES); the answers do not depend on it.  With
    `mesh_ctx` each rank filters and fits its share of every size
    bucket (`_share`) and every rank returns all groups' results and
    effects: the results as pickles, the effects as one float64 gather
    of each bucket's rows.  `significance_threshold` and
    `correlation_threshold` are accepted for the JAX signature and
    unused, as there."""
    rows = _as_rows(genotypes)
    device = rows.device
    put = lambda a: torch.as_tensor(a).to(device=device, dtype=torch.float64)
    y = np.asarray(y, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n, c = x.shape
    name_to_idx = {nm: i for i, nm in enumerate(snp_names)}
    yt, xt = put(y), put(x)

    lam = u = theta0 = y_rot = x_rot = logl0 = None
    if covariance is not None:
        eigenvalues, eigenvectors, warm = covariance
        lam, u = put(eigenvalues), put(eigenvectors)
        theta0 = put(np.asarray(warm, dtype=np.float64))
        y_rot, x_rot = u.T @ yt, u.T @ xt
        # reduced (covariates-only) ML fit for the LRT baseline
        logl0 = float(_ml_fit_diagonal(lam, y_rot, x_rot, theta0, ml_iterations)[3])

    # reduced (covariates-only) OLS fit
    b0 = np.linalg.solve(x.T @ x, x.T @ y)
    btxty0 = b0 @ (x.T @ y)
    yty = y @ y

    def index(groups, members):
        return torch.as_tensor(
            [[name_to_idx[s] for s in members(g)] for g in groups], device=device
        )

    def design(gs, x_):
        """[X | G'] per group: (B, n, c + s)."""
        return torch.cat([x_.expand(gs.shape[0], *x_.shape), gs.transpose(1, 2)], dim=2)

    # per-group dependent-column filtering: one batched QR per batch of
    # groups of the same size
    deps_of: Dict[str, np.ndarray] = {}
    by_size: Dict[int, List[str]] = {}
    for group, snps in grouping.items():
        by_size.setdefault(len(snps), []).append(group)
    for size, group_list in by_size.items():
        for batch in _batches(_share(group_list, mesh_ctx), n, c + size, group_batch):
            gs = rows(index(batch, lambda g: grouping[g]))
            for group, deps in zip(batch, dependent_columns_batched(design(gs, xt))):
                deps_of[group] = deps
    deps_of = _joined(deps_of, mesh_ctx)
    filtered: "OrderedDict[str, Tuple[List[str], List[str]]]" = OrderedDict()
    for group, snps in grouping.items():
        deps = {int(d) - c for d in deps_of[group] if d >= c}
        kept = [s for j, s in enumerate(snps) if j not in deps]
        dropped = [s for j, s in enumerate(snps) if j in deps]
        filtered[group] = (kept, dropped)

    # bucket by kept size, batch each bucket
    buckets: Dict[int, List[str]] = {}
    for group, (kept, _) in filtered.items():
        if kept:
            buckets.setdefault(len(kept), []).append(group)

    results: Dict[str, GroupResult] = {}
    effects_cols: Dict[str, np.ndarray] = {}
    for size, group_list in sorted(buckets.items()):
        p_coef = c + size
        df = n - p_coef
        h = p_coef - c
        shared_effects = []  # with a mesh: this rank's effects rows, on the device
        for batch in _batches(_share(group_list, mesh_ctx), n, p_coef, group_batch):
            gs = rows(index(batch, lambda g: filtered[g][0]))  # (B, s, n)
            if covariance is not None:
                bs, a_inv_diags, _, logls, _ = _ml_fit_diagonal(
                    lam, y_rot, design(gs @ u, x_rot), theta0, ml_iterations
                )
                logls = _host(logls)
            else:
                xg = design(gs, xt)
                xty = xg.transpose(1, 2) @ yt
                a_inv = torch.linalg.inv(xg.transpose(1, 2) @ xg)
                bs = (a_inv @ xty[..., None])[..., 0]
                a_inv_diags = torch.diagonal(a_inv, dim1=-2, dim2=-1)
                btxtys = _host(torch.sum(bs * xty, dim=-1))
                del xg
            effects_t = torch.einsum("bsn,bs->bn", gs, bs[:, c:])
            group_vars = _host(torch.var(effects_t, dim=1, correction=1))
            group_effects = None
            if compute_effects and mesh_ctx is not None:
                shared_effects.append(effects_t)
            elif compute_effects:
                group_effects = _host(effects_t)
            bs, a_inv_diags = _host(bs), _host(a_inv_diags)
            # the batch's tests at once, each group's as the JAX package
            # forms it one group at a time (grouped.py:208-238)
            with np.errstate(divide="ignore", invalid="ignore"):
                if covariance is not None:
                    # chi2 Wald per coefficient + LRT group test
                    # (gwas.cpp:889-903, 940-957)
                    se = np.sqrt(np.maximum(a_inv_diags, 0.0))
                    pvals = chi2_sf(1, (bs / se) ** 2)
                    lrt = 2.0 * (logls - logl0)
                    f_stat = lrt
                    f_p = np.where(lrt < 0, -1.0, chi2_sf(h, np.maximum(lrt, 0.0)))  # gwas.cpp:946-949
                    ok = np.isfinite(logls)
                else:
                    mse = (yty - btxtys) / df
                    se = np.sqrt(np.maximum(mse[:, None] * a_inv_diags, 0.0))
                    pvals = 2.0 * t_sf(df, np.abs(bs / se))
                    ssr = btxtys - btxty0
                    ok = ~((ssr < 0) | (mse <= 0))
                    f_stat = np.where(ok, (ssr / h) / mse, np.nan)
                    f_p = np.where(ok, f_sf(h, df, f_stat), np.nan)
            for bi, group in enumerate(batch):
                kept, dropped = filtered[group]
                results[group] = GroupResult(
                    group=group,
                    snp_names=kept,
                    beta=bs[bi],
                    se=se[bi],
                    p=pvals[bi],
                    f_statistic=float(f_stat[bi]),
                    f_p_value=float(f_p[bi]),
                    group_variance=float(group_vars[bi]),
                    dropped_snps=dropped,
                    success=bool(ok[bi]),
                )
                if group_effects is not None:
                    effects_cols[group] = group_effects[bi]
        if compute_effects and mesh_ctx is not None:
            # the bucket's effects rows of every rank's share, in bucket
            # order: one float64 gather of (groups, n)
            local = torch.cat(shared_effects) if shared_effects else yt.new_zeros((0, n))
            with timers.phase("GatherGroups"):
                gathered = _host(mesh_ctx.all_gather_rows(local, len(group_list)))
            effects_cols.update(zip(group_list, gathered))

    if mesh_ctx is not None:
        merged = _joined(results, mesh_ctx)
        results = {g: merged[g] for _, group_list in sorted(buckets.items()) for g in group_list}
    effects = None
    if compute_effects and effects_cols:
        cols = [g for g in grouping if g in effects_cols]
        # (groups, n) rows viewed transposed: the column-major layout that
        # LabeledMatrix.save writes and load returns, so neither copies
        # the matrix through a transpose
        effects = LabeledMatrix(
            [f"ind_{i}" for i in range(n)],
            cols,
            np.stack([effects_cols[g] for g in cols]).T,
        )
    return results, effects


def snp_correlations(genotypes: torch.Tensor) -> torch.Tensor:
    """Pearson correlations between the rows of (..., s, n) genotypes,
    (..., s, s); a constant row has norm 1 (gwas.cpp:1156)."""
    g = genotypes - genotypes.mean(dim=-1, keepdim=True)
    norms = torch.linalg.norm(g, dim=-1)
    norms = torch.where(norms == 0, torch.ones_like(norms), norms)
    return (g @ g.transpose(-1, -2)) / (norms[..., :, None] * norms[..., None, :])


def flag_from_correlations(corr: np.ndarray, snp_names: Sequence[str], p_values,
                           threshold: float = 0.99) -> List[str]:
    """The less-significant SNP of each pair correlated beyond
    `threshold` in a (s, s) correlation matrix."""
    flagged = set()
    m = len(snp_names)
    for i in range(m):
        for j in range(i + 1, m):
            if abs(corr[i, j]) > threshold:
                loser = i if p_values[i] > p_values[j] else j
                flagged.add(snp_names[loser])
    return sorted(flagged)


def flag_correlated_snps(
    genotypes, snp_names: Sequence[str], p_values, threshold: float = 0.99
) -> List[str]:
    """The less-significant SNP of each highly correlated pair
    (getLessSignificantCorrelatedSNPs, gwas.cpp:1156); genotypes (s, n),
    a tensor or an array (taken to the CPU)."""
    g = genotypes if isinstance(genotypes, torch.Tensor) else torch.as_tensor(np.asarray(genotypes))
    corr = snp_correlations(g.to(torch.float64)).cpu().numpy()
    return flag_from_correlations(corr, snp_names, p_values, threshold)


def flag_correlated_in_groups(
    genotypes,
    snp_names: Sequence[str],
    results: Dict[str, GroupResult],
    threshold: float = 0.99,
    group_batch: Optional[int] = None,
    mesh_ctx=None,
) -> Set[str]:
    """`flag_correlated_snps` over every group's kept SNPs and their
    p-values, the correlations of a batch of equal-size groups formed at
    once on the device.  With `mesh_ctx` each rank flags its share of
    each size (`_share`) and every rank returns the joined set."""
    rows = _as_rows(genotypes)
    name_to_idx = {nm: i for i, nm in enumerate(snp_names)}
    by_size: Dict[int, List[GroupResult]] = {}
    for res in results.values():
        by_size.setdefault(len(res.snp_names), []).append(res)
    flagged: Set[str] = set()
    for size, group_results in by_size.items():
        for batch in _batches(_share(group_results, mesh_ctx), rows.n_individuals, size, group_batch):
            idx = torch.as_tensor(
                [[name_to_idx[s] for s in r.snp_names] for r in batch], device=rows.device
            )
            corr = snp_correlations(rows(idx)).cpu().numpy()
            for res, cm in zip(batch, corr):
                c = len(res.beta) - len(res.snp_names)
                flagged.update(flag_from_correlations(cm, res.snp_names, res.p[c:], threshold))
    if mesh_ctx is not None:
        flagged = set().union(*mesh_ctx.all_gather_object(flagged))
    return flagged


def recursive_gwas(
    genotypes,
    snp_names: Sequence[str],
    y,
    x,
    group_size: int = 100,
    significance_threshold: float = 5e-8,
    max_iterations: int = 20,
    iteration_thresholds: Optional[Sequence[float]] = None,
    max_fit_ratio: Optional[float] = None,
    covariance=None,
    group_batch: Optional[int] = None,
    mesh_ctx=None,
) -> Tuple[List[str], Dict[str, GroupResult]]:
    """Iterative grouped fit -> keep significant -> regroup
    (computeRecursiveGWAS, gwas.cpp:239-284).  Returns the fixed-point
    significant SNP set and the final group results.  `mesh_ctx` goes to
    every pass's `grouped_gwas`, whose results every rank receives
    whole, so every rank takes the same regrouping decisions.

    iteration_thresholds: per-iteration keep thresholds (the last one
    repeats; --rgwas-thresholds, options.cpp:803-806); the final
    `significance_threshold` applies on the last pass.  max_fit_ratio
    caps the kept SNPs at ratio*n_individuals by p-value rank
    (relationFitSNPsIndividuals, --rgwas-ratio, options.cpp:799-802)."""
    rows = _as_rows(genotypes)
    current = list(snp_names)
    n_individuals = rows.n_individuals
    last_results: Dict[str, GroupResult] = {}
    for it in range(max_iterations):
        if iteration_thresholds:
            threshold = iteration_thresholds[min(it, len(iteration_thresholds) - 1)]
        else:
            threshold = significance_threshold
        grouping: "OrderedDict[str, List[str]]" = OrderedDict()
        for gi, start in enumerate(range(0, len(current), group_size), 1):
            grouping[f"g{gi}"] = current[start : start + group_size]
        results, _ = grouped_gwas(
            rows, snp_names, grouping, y, x,
            significance_threshold=significance_threshold,
            covariance=covariance,
            group_batch=group_batch,
            mesh_ctx=mesh_ctx,
        )
        last_results = results
        kept: List[Tuple[float, str]] = []
        for res in results.values():
            c = len(res.beta) - len(res.snp_names)
            for j, snp in enumerate(res.snp_names):
                if res.p[c + j] < threshold:
                    kept.append((res.p[c + j], snp))
        if max_fit_ratio is not None:
            cap = max(1, int(max_fit_ratio * n_individuals))
            kept = sorted(kept)[:cap]
        kept_set = {snp for _, snp in kept}
        significant = [s for s in snp_names if s in kept_set]
        if significant == current or not significant:
            break
        current = significant
    # the final significance filter (reference reports SNPs passing the
    # genome-wide threshold from the last joint fit)
    final: Set[str] = set()
    for res in last_results.values():
        c = len(res.beta) - len(res.snp_names)
        for j, snp in enumerate(res.snp_names):
            if res.p[c + j] < significance_threshold:
                final.add(snp)
    return [s for s in snp_names if s in final], last_results
