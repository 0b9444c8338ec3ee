"""Analysis dispatcher — the workflow sreml of the ported analyses.

Parity: Analysis (analysis.cpp:43-548) + main.cpp's dispatch chain
(main.cpp:101-234) + the loaders-from-options in auxiliar.h:246-310.
Port of the pieces of dissect_tpu/analysis/dispatcher.py on the
`--make-grm` -> `--gwas [--grm]` path (PLINK or BGEN input), of the GRM
family (`--make-grm-mr`, `--add-grms`, `--filter-matrix`,
`--gcta-grms-gz`, `--grm-epi`), of dense single-trait `--reml` (BLUE,
individual and SNP BLUPs, extra random-effect kernels, weights, reduced
models, initial variances, checkpoints, subsample pre-fits), of the
GWAS routes that need a dense V (extra kernels,
`--gwas-use-null-variances`, `--bfile-grm-list`/`--bgen-grm-list`), of
`--pca`, `--bivar-reml`/`--multi-reml`, regional `--reml`, grouped
`--gwas --groups/--group-all`, `--rgwas`, `--mpresiduals`, `--mpgwas`,
`--igwas`, `--glmm`, `--simulate`, `--predict`, `--accuracy-by-snp`,
`--cov-predict`, `--snp-stats` and `--effects`: every analysis.

A multi-rank launch (`torchrun`, runtime/distributed.py) runs the same
analysis on every rank; `use_distributed` decides where the mesh takes
part, at the JAX package's call sites: the GRM built row-sharded, the
dense REML fits row-sharded, the diagonalizations and full PCA solves
by the row-sharded divide-and-conquer eigensolver, and, under
--parallel-gwas, each rank testing its share of the SNPs (of each size
bucket's groups, for grouped and recursive GWAS).
Only rank 0 writes the log and the result files.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from dissect_tpu_torch.analysis.accuracy import compute_accuracy_by_snp
from dissect_tpu_torch.analysis.group_effects import (
    GroupEffects,
    crossed_correlations,
    pca_of_labeled_matrix,
    read_group_positions,
)
from dissect_tpu_torch.analysis.predict import predict_phenotypes, read_snp_effects
from dissect_tpu_torch.analysis.simulate import read_causal_snps, simulate_phenotypes
from dissect_tpu_torch.glm.glmm import GLMM
from dissect_tpu_torch.gwas.grouped import (
    CenteredRows,
    centered_genotypes,
    flag_correlated_in_groups,
    grouped_gwas,
    recursive_gwas,
)
from dissect_tpu_torch.gwas.igwas import IGwasResults, igwas
from dissect_tpu_torch.gwas.mlm import mlm_gwas_fixed_v, mlm_gwas_ml_refit
from dissect_tpu_torch.gwas.mp import (
    DeviceResiduals,
    MpGwasResults,
    compute_mp_residuals,
    mp_gwas,
)
from dissect_tpu_torch.gwas.ols import GwasResults, ols_gwas
from dissect_tpu_torch.io import grm_io
from dissect_tpu_torch.io.bed import PlinkData, read_plink
from dissect_tpu_torch.io.bgen import BgenData, read_bgen
from dissect_tpu_torch.io.covariate import load_effect_prediction, read_covariates
from dissect_tpu_torch.io.groups import by_all, by_group_file, by_position
from dissect_tpu_torch.io.ids import intersection_keeping_order
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.io.phenotype import n_phenotype_columns, read_phenotype
from dissect_tpu_torch.model.kernels import (
    Kernel,
    KernelType,
    couples_kernel,
    grm_from_plink,
    kernel_from_discrete,
    kernel_from_multi_discrete,
    kernel_squared_exponential,
)
from dissect_tpu_torch.pca.pca import compute_pca
from dissect_tpu_torch.reml.builders import build_variance_model, initial_residual_variance
from dissect_tpu_torch.reml.multi import MultiREML
from dissect_tpu_torch.reml.reduced import write_lrt_table
from dissect_tpu_torch.reml.regional import compute_regional
from dissect_tpu_torch.reml.single import SingleREML
from dissect_tpu_torch.reml.snp_blup import compute_snp_blup, write_snp_blup
from dissect_tpu_torch.reml.summary import write_blue, write_blup_indiv, write_reml_summary
from dissect_tpu_torch.runtime.checkpoint import read_initial_variances
from dissect_tpu_torch.runtime.device import cli_device
from dissect_tpu_torch.runtime.distributed import (
    mesh_summary,
    shutdown_runtime,
    startup_runtime,
    use_distributed,
)
from dissect_tpu_torch.runtime.distributed_io import (
    decode_snp_shard,
    gather_snp_fields,
    snp_row_index,
    stream_grm_sharded,
    to_host,
)
from dissect_tpu_torch.runtime.dtypes import GRM_DTYPE, bulk_dtype, configure_precision
from dissect_tpu_torch.runtime.log import get_logger, result_open, set_zout
from dissect_tpu_torch.runtime.mesh import RowShards
from dissect_tpu_torch.runtime.options import Options
from dissect_tpu_torch.runtime.timers import timers

# SNPs per device dispatch for genome-scale streaming (bounds host and
# device memory; the batched analog of the reference's per-file loop)
GWAS_CHUNK_SNPS = 65536
# individuals up to which a chunk holds GWAS_CHUNK_SNPS SNPs; above it the
# chunk shrinks so that its (SNPs, N) float64 temporaries keep their size
GWAS_CHUNK_INDIVIDUALS = 20000


def gwas_chunk_snps(n_individuals: int) -> int:
    """SNPs a chunk holds at N individuals: GWAS_CHUNK_SNPS up to
    GWAS_CHUNK_INDIVIDUALS, then floor(GWAS_CHUNK_SNPS *
    GWAS_CHUNK_INDIVIDUALS / N) (2,898 at N = 452,264), at least one.  A
    function of N alone, so a scan's chunks and peak memory do not
    depend on what else the card holds."""
    whole = GWAS_CHUNK_SNPS * GWAS_CHUNK_INDIVIDUALS
    return max(1, min(GWAS_CHUNK_SNPS, whole // max(n_individuals, 1)))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _map_snp_chunks(fn, data: Union[PlinkData, BgenData], mean: np.ndarray, device,
                    chunk: Optional[int] = None, ctx=None, gathers: bool = False) -> list:
    """fn(z, snp_names) over blocks of `chunk` SNPs (by default
    `gwas_chunk_snps` of the data's individuals; bounds device and host
    memory at genome scale, gwas.cpp:126-312): each block's raw dosages
    are decoded on the data's device (`decode_rows`: K4 for PLINK data;
    BGEN dosages are resident there), and z is their centered rows in
    float64 on `device`.  Returns fn's results, block by block.

    With a MeshContext (--parallel-gwas, gwas.cpp:557-687) each rank
    decodes only its `shard_snp_rows` share of a block and fn sees those
    rows, called as fn(z, names, n_snps_in_block); each per-SNP field of
    its result is then all-gathered back to the block, unless fn gathers
    itself (`gathers`).

    Spans (runtime/timers.py): gwas.chunk for each block, and in it
    gwas.decode (the decode and the centering) before fn."""
    chunk = chunk or gwas_chunk_snps(data.n_individuals)
    names = data.snp_names
    parts = []
    for start in range(0, data.n_snps, chunk):
        stop = min(start + chunk, data.n_snps)
        with timers.span("gwas.chunk"):
            if ctx is None:
                with timers.span("gwas.decode"):
                    dosage = data.decode_rows(start, stop).to(device)
                    z = centered_genotypes(dosage, torch.as_tensor(mean[start:stop]).to(device))
                parts.append(fn(z, names[start:stop]))
                continue
            idx = start + snp_row_index(stop - start, ctx)
            with timers.span("gwas.decode"):
                dosage = decode_snp_shard(data, start, stop, ctx).to(device)
                z = centered_genotypes(dosage, torch.as_tensor(mean[idx]).to(device))
            res = fn(z, [names[i] for i in idx], stop - start)
            if not gathers:
                res = gather_snp_fields(res, stop - start, ctx)
                if hasattr(res, "snp_names"):
                    res.snp_names = list(names[start:stop])
            parts.append(res)
    return parts


def _chunked_gwas(fn, data: Union[PlinkData, BgenData], mean: np.ndarray, device, dtype,
                  chunk: Optional[int] = None, row_variance: bool = False, ctx=None,
                  gathers: bool = False):
    """Run a per-SNP GWAS solver fn(z) over SNP blocks (`_map_snp_chunks`,
    z in `dtype`) and concatenate; with a MeshContext each rank tests its
    share of every block (fn(z, n_snps) when the solver gathers itself).

    Returns (results, per-SNP variance of the centered rows or None)."""
    variances = []

    def run(z, _, *m):
        if row_variance:
            var = _host(torch.var(z, dim=1, unbiased=True))
            variances.append(var if ctx is None else to_host(var, m[0], ctx))
        return fn(z.to(dtype), *m) if gathers else fn(z.to(dtype))

    parts: List[GwasResults] = _map_snp_chunks(
        run, data, mean, device, chunk, ctx=ctx, gathers=gathers
    )
    row_var = np.concatenate(variances) if row_variance else None
    if len(parts) == 1:
        return parts[0], row_var
    first = parts[0]
    cat = lambda attr: np.concatenate([getattr(p, attr) for p in parts])
    out = GwasResults(
        snp_beta=cat("snp_beta"),
        snp_se=cat("snp_se"),
        snp_stat=cat("snp_stat"),
        snp_p=cat("snp_p"),
        cov_beta=cat("cov_beta"),
        cov_se=cat("cov_se"),
        cov_p=cat("cov_p"),
        df=first.df,
        model=first.model,
    )
    if first.converged is not None:
        out.converged = cat("converged")
    if first.group_p is not None:
        out.group_p = cat("group_p")
    return out, row_var


class Analysis:
    """One configured run on one device: dispatches to the requested analysis."""

    def __init__(self, options: Options, device):
        self.options = options
        self.args = options.args
        self.device = torch.device(device)
        self.log = get_logger()

    # ----------------------------------------------------------- loaders ---
    def load_genotype(self) -> Union[PlinkData, BgenData]:
        """loadGenotypeUsingOptions parity (auxiliar.h:246-263)."""
        a = self.args
        if a.bgen:
            data = read_bgen(a.bgen, device=self.device)
        elif a.bfile:
            data = read_plink(a.bfile, device=self.device)
        elif a.bfile_list:
            with open(a.bfile_list) as fh:
                prefixes = [ln.strip() for ln in fh if ln.strip()]
            data = read_plink(prefixes[0], device=self.device)
            for prefix in prefixes[1:]:
                data = data.append_snps(read_plink(prefix, device=self.device))
        else:
            raise ValueError("no genotype input (--bfile / --bfile-list / --bgen)")
        keep_snps = keep_inds = None
        if a.extract:
            with open(a.extract) as fh:
                wanted = {ln.split()[0] for ln in fh if ln.strip()}
            keep_snps = [s for s in data.snp_names if s in wanted]
        if a.keep:
            with open(a.keep) as fh:
                wanted = {
                    parts[0] + "@" + parts[1]
                    for parts in (ln.split() for ln in fh)
                    if len(parts) >= 2
                }
            keep_inds = [k for k in data.individual_keys if k in wanted]
        if keep_snps is not None or keep_inds is not None:
            data = data.filter(keep_snps=keep_snps, keep_individuals=keep_inds)
        return data

    def _kernel_from_loaded(self, name: str, loaded: dict) -> Kernel:
        """A Kernel on the device from a read_grm() dict.  A dense GRM
        goes to the GRM dtype (float32), which holds the values this
        package writes exactly."""
        put = lambda a, dtype: torch.as_tensor(a).to(device=self.device, dtype=dtype)
        if loaded["diagonalized"]:
            return Kernel(
                name=name,
                type=KernelType.GRM,
                individual_keys=loaded["individual_keys"],
                snp_names=loaded["snp_names"],
                diagonalized=True,
                eigenvalues=put(loaded["eigenvalues"], torch.float64),
                eigenvectors=put(loaded["eigenvectors"], torch.float64),
            )
        return Kernel(
            name=name,
            type=KernelType.GRM,
            individual_keys=loaded["individual_keys"],
            snp_names=loaded["snp_names"],
            matrix=put(loaded["kernel"], GRM_DTYPE),
            counts=put(loaded["counts"], GRM_DTYPE),
        )

    def load_reml_kernels(self):
        """The multi-GRM loadGRMUsingOptions overload
        (auxiliar.cpp:702-860): --grm-list rows
        'name grm_prefix N|F|L [genotypes]' load several NAMED GRMs
        fitted jointly; F (file) / L (list file) attach the genotype
        source used for that sub-covariance's SNP BLUPs
        (computeSNPsBLUP's per-name loop, reml.cpp:3098-3135).

        Returns (kernels, blup_sources) with blup_sources mapping a
        kernel name to its genotype prefixes (None = the analysis'
        default --bfile genotypes)."""
        a = self.args
        blup_sources: dict = {}
        if not a.grm_list:
            kern = self.load_grm()
            if a.snp_blup:
                if a.blup_bfile_list:
                    # SNP effects from a separate genotype list
                    # (--blup-bfile-list, options.cpp:736-740)
                    with open(a.blup_bfile_list) as fh:
                        blup_sources[kern.name] = [ln.strip() for ln in fh if ln.strip()]
                elif a.bfile or a.bfile_list or a.bgen:
                    blup_sources[kern.name] = None
            return [kern], blup_sources
        kernels: List[Kernel] = []
        with open(a.grm_list) as fh:
            for line in fh:
                parts = line.split()
                if not parts:
                    continue
                name, prefix = parts[0], parts[1]
                kern = self._kernel_from_loaded(name, grm_io.read_grm(prefix))
                if not kern.diagonalized:
                    kern = kern.sanitize(a.min_overlap_snps)
                    if a.grm_cutoff is not None:
                        kern = kern.prune(a.grm_cutoff)
                kernels.append(kern)
                flag = parts[2] if len(parts) > 2 else "N"
                if a.snp_blup and flag == "F":
                    blup_sources[name] = [parts[3]]
                elif a.snp_blup and flag == "L":
                    with open(parts[3]) as lf:
                        blup_sources[name] = [ln.strip() for ln in lf if ln.strip()]
                elif flag not in ("N", "F", "L"):
                    raise ValueError(
                        f"invalid genotype flag {flag!r} in [ {a.grm_list} ] "
                        "(valid: N, F, L; auxiliar.cpp:786)"
                    )
        if not kernels:
            raise ValueError(f"no GRMs listed in [ {a.grm_list} ]")
        return kernels, blup_sources

    def load_grm(self, allow_compute: bool = True) -> Kernel:
        """loadGRMUsingOptions parity (auxiliar.h:264-275): read a stored
        .grm.* artifact or a GCTA gz GRM, or compute it from genotypes;
        --grm-epi turns a stored or computed GRM into K .* K before it is
        sanitized (dissect_tpu/analysis/dispatcher.py:261-304)."""
        a = self.args
        if a.gcta_grms_gz:
            loaded = grm_io.read_gcta_grm_gz(a.gcta_grms_gz)
            put = lambda x: torch.as_tensor(x).to(device=self.device, dtype=GRM_DTYPE)
            kern = Kernel(
                name="GRM",
                type=KernelType.GCTA_GRM,
                individual_keys=loaded["individual_keys"],
                matrix=put(loaded["kernel"]),
                counts=put(loaded["counts"]),
            )
            if a.grm_cutoff is not None:
                kern = kern.prune(a.grm_cutoff)
            return kern
        if a.grm:
            kern = self._kernel_from_loaded("GRM", grm_io.read_grm(a.grm))
        elif allow_compute and (a.bfile or a.bfile_list or a.bgen):
            data = self.load_genotype()
            ctx = use_distributed(a, data.n_individuals)
            if ctx is not None:
                kern = self._grm_sharded(data, ctx)
            else:
                kern = grm_from_plink(
                    data,
                    flat_normalization=a.grm_flat_norm,
                    drop_monomorphic=a.keep_zerostd_snps,
                    device=self.device,
                )
        else:
            raise ValueError("no GRM input (--grm / --bfile / --bgen)")
        if a.grm_epi:
            kern = kern.epistatic()
        n_before = kern.n
        kern = kern.sanitize(a.min_overlap_snps)
        if kern.n < a.min_prop_grm_inds_kept * n_before:
            # kernel.cpp:2019: reject a GRM losing too many individuals
            raise ValueError(
                f"GRM sanitization kept only {kern.n}/{n_before} individuals "
                f"(< {a.min_prop_grm_inds_kept:.0%}; --min-prop-grm-inds-kept)"
            )
        if a.grm_cutoff is not None:
            kern = kern.prune(a.grm_cutoff)
        return kern

    def _grm_sharded(self, data: Union[PlinkData, BgenData], ctx) -> Kernel:
        """Multi-rank GRM (the pdsyrk_ grid path, matrix.cpp:2682 /
        kernel.cpp:92-109): each rank decodes its SNP rows of every chunk
        and accumulates its row block of the kernel and counts
        (`stream_grm_sharded`).  The kernel keeps them as RowShards, 8 N^2
        / world bytes a rank, through sanitizing, filtering and the
        row-sharded REML engine; a step that needs the GRM whole (the
        writers, the eigensolvers, PCA, the multi-trait slices) gathers
        it."""
        stats = data.stats()
        if bool(stats.monomorphic.any()):
            names = data.snp_names
            if not self.args.keep_zerostd_snps:
                bad = [names[i] for i in np.nonzero(stats.monomorphic)[0][:10]]
                raise ValueError(
                    "monomorphic SNPs present (filter them first), e.g. " + ", ".join(bad)
                )
            data = data.filter(keep_snps=[names[i] for i in np.nonzero(~stats.monomorphic)[0]])
            stats = data.stats()
        self.log.message(f"GRM row-sharded over {ctx.world} ranks")
        n = data.n_individuals
        kern, counts = stream_grm_sharded(
            data, ctx, stats.mean, 1.0 / stats.std,
            flat_normalization=self.args.grm_flat_norm,
        )
        return Kernel(
            name="GRM",
            type=KernelType.GRM,
            individual_keys=data.individual_keys,
            matrix=RowShards(kern.to(self.device), n, ctx),
            counts=RowShards(counts.to(self.device), n, ctx),
            snp_names=data.snp_names,
        )

    def load_phenotypes(self, columns: Optional[List[int]] = None):
        a = self.args
        if a.phenos:
            # one file per trait (--phenos, options.cpp:443-446)
            return [read_phenotype(f, a.pheno_col) for f in a.phenos]
        if not a.pheno:
            raise ValueError("no phenotype file (--pheno / --phenos)")
        if columns is None:
            if a.all_phenos:
                columns = list(range(1, n_phenotype_columns(a.pheno) + 1))
            elif a.pheno_cols:
                columns = [int(c) for c in a.pheno_cols.split(",")]
            else:
                columns = [a.pheno_col]
        return [read_phenotype(a.pheno, c) for c in columns]

    def load_covariate(self, keys):
        a = self.args
        if a.covar or a.qcovar:
            return read_covariates(a.covar, a.qcovar)
        return read_covariates(default_keys=keys)

    # --------------------------------------------------------- analyses ---
    def make_grm(self):
        """--make-grm (analysis.cpp:43-111)."""
        a = self.args
        with timers.phase("ComputeGRM"):
            kern = self.load_grm()
        if kern.counts is None and (a.store_both or not a.diagonalize):
            # dissect_tpu writes to_host(None) here and fails with an
            # IndexError (dispatcher.py:402-403); the port names the cause
            raise ValueError(
                f"--make-grm cannot write [ {a.out}.grm.dat ]: the {kern.type.value} "
                "kernel has no SNP counts (N matrix) to store beside it "
                "(--grm-epi builds K .* K without counts; use --diagonalize)"
            )
        if a.diagonalize:
            with timers.phase("DiagonalizeGRM"):
                diag = kern.diagonalize(mesh=use_distributed(a, kern.n))
            self._write_grm_diagonalized(diag)
            if a.store_both:
                # --store-both: also keep the undecomposed GRM
                # (options.cpp:511-515)
                self._write_grm(kern, a.out + ".nondiagonal")
        else:
            self._write_grm(kern, a.out)
        self.log.message(f"GRM stored at [ {a.out}.grm.* ]")

    def make_grm_most_related(self):
        """--make-grm-mr (makeGRMAndStoreMostRelated,
        analysis.cpp:113-135): store the full GRM, the subset of
        individuals with relatedness outside [--mostr-lower-thr,
        --mostr-upper-thr] as <out>.mostRelated.grm.*, and report how
        many individuals each --cutoff-thrs prune level would drop."""
        a = self.args
        with timers.phase("ComputeGRM"):
            kern = self.load_grm()

        def write(k, prefix):
            k = k.whole()
            counts = (
                _host(k.counts)
                if k.counts is not None
                else np.full((k.n, k.n), float(len(k.snp_names)))
            )
            grm_io.write_grm(prefix, _host(k.matrix), counts, k.individual_keys, k.snp_names)

        write(kern, a.out)
        mr = kern.keep_with_relatedness_outside(a.mostr_lower_thr, a.mostr_upper_thr)
        write(mr, a.out + ".mostRelated")
        self.log.message(
            f"GRM stored at [ {a.out}.grm.* ]; most-related subset "
            f"({mr.n}/{kern.n} individuals) at "
            f"[ {a.out}.mostRelated.grm.* ]"
        )
        for cutoff in a.cutoff_thrs or []:
            pruned = kern.prune(cutoff)
            dropped = kern.n - pruned.n
            self.log.message(
                f"{dropped} individuals have been filtered from {kern.n} "
                f"when cutoff is {cutoff}. ({dropped / kern.n})"
            )
        return kern

    def make_filter_matrix(self):
        """--filter-matrix (makeFilterLabeledMatrix): subset a stored
        LabeledMatrix by row/column label files."""
        a = self.args
        if not (a.imatrix and a.row_labels and a.col_labels):
            raise ValueError(
                "--imatrix, --row-labels and --col-labels are required with "
                "--filter-matrix (options.cpp:1609)"
            )
        if a.imatrix == a.out:
            raise ValueError("input and output prefixes are the same")
        lm = LabeledMatrix.load(a.imatrix)
        with open(a.row_labels) as fh:
            rows = [l.strip() for l in fh if l.strip()]
        with open(a.col_labels) as fh:
            cols = [l.strip() for l in fh if l.strip()]
        lm.filter(keep_rows=rows, keep_cols=cols).save(a.out)
        self.log.message(f"filtered matrix stored at [ {a.out}.* ]")

    def make_add_grms(self):
        """--add-grms: sum GRMs from --grm-list via the denormalize/add
        kernel algebra (addGRMs, kernel.cpp:1705).  The sum runs in
        float64 on the device: its result is written as float64, and
        raw = K .* N in float32 would round it."""
        a = self.args
        if not a.grm_list:
            raise ValueError("--add-grms requires --grm-list")
        with open(a.grm_list) as fh:
            prefixes = [l.strip() for l in fh if l.strip()]
        put = lambda x: torch.as_tensor(x).to(device=self.device, dtype=torch.float64)
        kernels = []
        for prefix in prefixes:
            loaded = grm_io.read_grm(prefix)
            kernels.append(
                Kernel(
                    name="GRM",
                    type=KernelType.GRM,
                    individual_keys=loaded["individual_keys"],
                    snp_names=loaded["snp_names"],
                    matrix=put(loaded["kernel"]),
                    counts=put(loaded["counts"]),
                )
            )
        common = kernels[0].individual_keys
        for k in kernels[1:]:
            common = intersection_keeping_order(common, k.individual_keys)
        total = kernels[0].filter_individuals(common)
        for k in kernels[1:]:
            total = total.add(k.filter_individuals(common))
        self._write_grm(total, a.out)
        self.log.message(f"summed GRM stored at [ {a.out}.grm.* ]")

    @timers.timed("WriteGRM")
    def _write_grm_diagonalized(self, diag: Kernel):
        u = diag.eigenvectors
        # row-sharded eigenvectors reach rank 0's host one row block at a
        # time; the other ranks have nothing to write
        u = u.to_root_host() if isinstance(u, RowShards) else _host(u)
        if u is None:
            return
        grm_io.write_grm_diagonalized(
            self.args.out,
            _host(diag.eigenvalues),
            u,
            diag.individual_keys,
            diag.snp_names,
        )

    @timers.timed("WriteGRM")
    def _write_grm(self, kern: Kernel, prefix: str):
        kern = kern.whole()
        grm_io.write_grm(
            prefix, _host(kern.matrix), _host(kern.counts), kern.individual_keys, kern.snp_names
        )

    def make_pca(self):
        """--pca (analysis.cpp:233-243): the GRM stored or built in line,
        then its top --num-eval eigenpairs."""
        a = self.args
        with timers.phase("LoadGRM" if (a.grm or a.gcta_grms_gz) else "ComputeGRM"):
            kern = self.load_grm()
        with timers.phase("PCA"):
            pca = compute_pca(kern, n_components=a.num_eval, mesh=use_distributed(a, kern.n))
        with timers.phase("WritePCA"):
            pca.write(a.out)
        self.log.message(f"PCA stored at [ {a.out}.pca.* ]")
        return pca

    def extra_kernels(self, base_kernel: Kernel) -> List[Kernel]:
        """Additional random-effect kernels from options
        (addKernelsUsingOptions, auxiliar.h:276-310): discrete /
        multi-discrete covariate kernels, partner-resorted (couples)
        GRMs, squared-exponential kernels, and GRM x environment
        interaction kernels, all on the device."""
        a = self.args
        dev = self.device
        kernels: List[Kernel] = []
        if a.random_effects:
            table = {}
            with open(a.random_effects) as fh:
                for line_no, line in enumerate(fh):
                    parts = line.split()
                    if not parts or (line_no == 0 and parts[0].upper() == "FID"):
                        continue
                    table[parts[0] + "@" + parts[1]] = parts[1 + a.random_effects_cols]
            keys = [k for k in base_kernel.individual_keys if k in table]
            env = kernel_from_discrete("RE1", keys, [table[k] for k in keys], device=dev)
            kernels.append(env)
            if a.gxe:
                kernels.append(base_kernel.filter_individuals(keys).interaction(env, "GxE"))
        if a.multirandom_effects:
            table = {}
            ncols = a.multirandom_effects_cols
            with open(a.multirandom_effects) as fh:
                for line_no, line in enumerate(fh):
                    parts = line.split()
                    if not parts or (line_no == 0 and parts[0].upper() == "FID"):
                        continue
                    cats = parts[2 : 2 + ncols]
                    if len(cats) == 1:
                        cats = cats[0].split(",")
                    table[parts[0] + "@" + parts[1]] = cats
            keys = [k for k in base_kernel.individual_keys if k in table]
            kernels.append(
                kernel_from_multi_discrete("MRE1", keys, [table[k] for k in keys], device=dev)
            )
        if a.indirect_effects_couples:
            couples = {}
            with open(a.indirect_effects_couples) as fh:
                for line in fh:
                    parts = line.split()
                    if len(parts) >= 4:
                        couples[parts[0] + "@" + parts[1]] = parts[2] + "@" + parts[3]
            coup = couples_kernel(base_kernel, couples)
            if coup is not None:
                kernels.append(coup)
            else:
                self.log.message(
                    "WARNING: not enough coupled individuals; indirect-effects kernel skipped"
                )
        if a.sqrt_exp_coord_files:
            coords, keys = [], []
            with open(a.sqrt_exp_coord_files) as fh:
                for line_no, line in enumerate(fh):
                    parts = line.split()
                    if not parts or (line_no == 0 and parts[0].upper() == "FID"):
                        continue
                    keys.append(parts[0] + "@" + parts[1])
                    coords.append([float(v) for v in parts[2:]])
            kernels.append(
                kernel_squared_exponential("SEK-1", keys, np.asarray(coords), device=dev)
            )
        return kernels

    # ------------------------------------------------------------- REML ---
    def make_reml(self):
        """--reml (analysis.cpp:137-157, singlereml.cpp:56-228); with
        --all-phenos / multiple --pheno-cols the fit loops over phenotype
        columns (the singlereml.cpp:84-102 file x column loop), writing
        one output set per column."""
        a = self.args
        if (a.region_size or a.groups) and (a.bfile or a.bfile_list):
            return self.make_regional_reml()
        phenos = self.load_phenotypes()
        if len(phenos) == 1:
            return self._reml_one(phenos[0])
        base, outs = a.out, []
        for i, pheno in enumerate(phenos, start=1):
            a.out = f"{base}.{i}"
            try:
                outs.append(self._reml_one(pheno))
            finally:
                a.out = base
        return outs

    def _reml_one(self, pheno):
        a = self.args
        stored = a.grm or a.grm_list or a.gcta_grms_gz
        with timers.phase("LoadGRM" if stored else "ComputeGRM"):
            base_kernels, blup_sources = self.load_reml_kernels()
        kern = base_kernels[0]
        covar = self.load_covariate(pheno.keys)
        kernels = base_kernels + self.extra_kernels(kern)
        if a.epistasis_var:
            # epistatic K.*K as an ADDITIONAL variance component
            # (--epistasis-var, singlereml.cpp:72-90); --grm-epi instead
            # REPLACES the GRM with its epistatic form
            kernels.append(kern.epistatic())
        env_weights = None
        if a.weights:
            # per-individual residual weights E = diag(w) (--weights /
            # --weights-col, options.cpp:770-778, reml.cpp:334-446)
            env_weights = read_phenotype(a.weights, a.weights_col)
        ctx = use_distributed(a, kern.n)
        if ctx is not None:
            self.log.message(
                f"REML on {ctx.world} ranks (row-sharded covariance, "
                "distributed blocked Cholesky)"
            )
        sreml = SingleREML(
            kernels, pheno, covar, self.options.reml_options(),
            environmental_weights=env_weights,
            scale_weights=not a.no_scale_weights,
            device=self.device,
            mesh=ctx,
            distributed_block=a.default_block_size,
        )
        initial_variances = None
        replicates = a.subsample_replicates
        if a.reml_subsample and replicates == 0:
            replicates = 10  # --reml-subsample default (options.cpp:603-606)
        if a.initial_variances:
            initial_variances = read_initial_variances(a.initial_variances)
        elif replicates > 0:
            with timers.phase("REML"):
                initial_variances = sreml.subsample_prefit(
                    replicates, a.subsample_proportion, a.random_seed
                )
        fit_args = dict(
            compute_blue=True,
            compute_blup=a.indiv_blup,
            compute_blup_errors=a.indiv_blup_error,
            initial_variances=initial_variances,
            checkpoint_path=a.checkpoint,
        )
        lrts = None
        if len(kernels) > 1 and not a.skip_test_reduced_models and not a.use_ml:
            # computeREMLWithReducedModels (reml.cpp:1301-1460): refit
            # with each named genetic sub-covariance removed and LRT
            out, lrts = sreml.compute_with_reduced_models(
                elements_to_test=a.reduced_with_only,
                include_blue=a.write_blue_reduced,
                **fit_args,
            )
        else:
            out = sreml.compute(**fit_args)
        x_names = covar.filter_individuals(out.individual_keys).column_names
        with timers.phase("WriteREML"):
            if lrts is not None:
                write_lrt_table(a.out, lrts)
                if a.write_blue_reduced:
                    for row in lrts:
                        if row.get("blue") is not None:
                            beta, se = row["blue"]
                            write_blue(f"{a.out}.reduced_{row['removed']}", beta, se, x_names)
            write_reml_summary(a.out, sreml.model, out.result, use_ml=a.use_ml)
            if a.blue and out.blue is not None:
                write_blue(a.out, out.blue, out.blue_se, x_names)
            if a.indiv_blup and out.blup:
                for name, blup in out.blup.items():
                    errors = (out.blup_errors or {}).get(name)
                    write_blup_indiv(a.out, name, out.individual_keys, blup, errors=errors)
        if a.snp_blup and blup_sources:
            self._snp_blups(sreml, out, base_kernels, blup_sources)
        self.log.message(f"REML results stored at [ {a.out}.reml ]")
        return out

    def _snp_blups(self, sreml, out, base_kernels, blup_sources):
        """--snp-blup: one .<name>.blup.snps per named sub-covariance with
        genotype data (computeSNPsBLUP, reml.cpp:3098-3135), from the
        fitted Py on the device."""
        a = self.args
        py = sreml.engine.final_py()
        for k in base_kernels:
            vname = f"Var({k.name})"
            if k.name not in blup_sources or vname not in out.result.variance_names:
                continue
            sources = blup_sources[k.name]
            with timers.phase("LoadGenotypes"):
                if sources is None:
                    datasets = [(None, self.load_genotype())]
                else:
                    datasets = [(p, read_plink(p, device=self.device)) for p in sources]
            for prefix, data in datasets:
                with timers.phase("SNPBLUP"):
                    blup_result = compute_snp_blup(
                        data,
                        out.individual_keys,
                        py,
                        out.result.variance(vname),
                        grm_snp_names=None if a.blup_no_filter_snps else (k.snp_names or None),
                    )
                tag = "" if prefix is None else "." + prefix.replace("/", "_")
                with timers.phase("WriteREML"):
                    write_snp_blup(a.out + tag, k.name, blup_result)

    def make_regional_reml(self):
        """Regional heritability (--reml --region-size/--groups,
        singlereml.cpp:230-360): per-region Global/Regional-GRM fits with
        LRTs, written as an .lrt table and a .regional summary."""
        a = self.args
        with timers.phase("LoadGenotypes"):
            data = self.load_genotype()
        pheno = self.load_phenotypes()[0]
        covar = self.load_covariate(pheno.keys)
        if a.groups:
            grouping = by_group_file(data, a.groups)
        else:
            grouping = by_position(data, a.region_size * 1000, a.region_overlap * 1000)
        grouping = {g: snps for g, snps in grouping.items() if len(snps) >= a.min_snps_region}
        with timers.phase("ComputeGRM"):
            grm = grm_from_plink(data, device=self.device)
        results = compute_regional(
            data, grouping, pheno, covar, self.options.reml_options(), grm=grm,
            device=self.device,
        )
        all_lrts = []
        for group, res in results.items():
            for row in res["lrts"]:
                all_lrts.append({**row, "removed": f"{group}:{row['removed']}"})
        with timers.phase("WriteREML"):
            write_lrt_table(a.out, all_lrts)
            with result_open(a.out + ".regional") as fh:
                fh.write("REGION NSNPS PROPORTION GLOBAL_VAR REGIONAL_VAR E_VAR SUCCESS\n")
                for group, res in results.items():
                    r = res["full"].result
                    ok = r.success
                    gv = r.variance("Var(Global-GRM)") if ok else float("nan")
                    rv = r.variance("Var(Regional-GRM)") if ok else float("nan")
                    ev = r.variance("Var(E)") if ok else float("nan")
                    fh.write(
                        f"{group} {res['n_snps']} {res['proportion']:.4g} "
                        f"{gv:.6g} {rv:.6g} {ev:.6g} {int(ok)}\n"
                    )
        self.log.message(
            f"regional REML stored at [ {a.out}.regional / {a.out}.lrt ] "
            f"({len(results)} regions)"
        )
        return results

    def make_multi_reml(self):
        """--bivar-reml / --multi-reml (multireml.cpp:57-137): one joint
        fit of the traits in --pheno-cols (all columns by default; the
        first two for --bivar-reml), with per-trait --covars/--qcovars."""
        a = self.args
        stored = a.grm or a.gcta_grms_gz
        with timers.phase("LoadGRM" if stored else "ComputeGRM"):
            kern = self.load_grm()
        if a.pheno_cols:
            columns = [int(c) for c in a.pheno_cols.split(",")]
        else:
            columns = list(range(1, n_phenotype_columns(a.pheno) + 1))
        if a.bivarREML and len(columns) != 2:
            columns = columns[:2]
        phenos = self.load_phenotypes(columns)
        covariates = None
        if a.covars or a.qcovars:
            cfiles = a.covars.split(",") if a.covars else [None] * len(phenos)
            qfiles = a.qcovars.split(",") if a.qcovars else [None] * len(phenos)
            covariates = [
                read_covariates(c or None, q or None, default_keys=p.keys)
                for c, q, p in zip(cfiles, qfiles, phenos)
            ]
        # the joint covariance is (sum_t n_t)^2: gate on the total dimension
        ctx = use_distributed(a, sum(len(p.keys) for p in phenos))
        if ctx is not None:
            self.log.message(f"multi-trait REML on {ctx.world} ranks (row-sharded covariance)")
        sreml = MultiREML(
            [kern], phenos, covariates, self.options.reml_options(),
            use_correlations=a.use_correlations,
            environmental_covariance=not a.no_environment_cov,
            device=self.device,
            mesh=ctx,
            distributed_block=a.default_block_size,
        )
        initial_variances = None
        if a.initial_variances:
            initial_variances = read_initial_variances(a.initial_variances)
        out = sreml.compute(
            initial_h2s=a.initial_h2s,
            initial_variances=initial_variances,
            checkpoint_path=a.checkpoint,
        )
        with timers.phase("WriteREML"):
            write_reml_summary(a.out, sreml.model, out.result, use_ml=a.use_ml)
            with result_open(a.out + ".correlations") as fh:
                fh.write("NAME VALUE SE\n")
                for row in out.correlations:
                    fh.write(f"{row.name} {row.value:.8g} {row.std_error:.8g}\n")
        self.log.message(f"multi-trait REML results stored at [ {a.out}.reml ]")
        return out

    # ------------------------------------------------------------- GWAS ---
    def make_gwas(self):
        """--gwas (gwas.cpp:126-312): OLS without a GRM, mixed model with."""
        a = self.args
        if a.bfile_grm_list or a.bgen_grm_list:
            return self._gwas_genotype_grm_list()
        with timers.phase("LoadGenotypes"):
            data = self.load_genotype()
        pheno = self.load_phenotypes()[0]
        covar = self.load_covariate(pheno.keys)

        kern = None
        extras: List[Kernel] = []
        if a.grm:
            with timers.phase("LoadGRM"):
                kern = self.load_grm(allow_compute=False)
            extras = self.extra_kernels(kern)
            common = intersection_keeping_order(
                kern.individual_keys, pheno.keys, covar.keys, data.individual_keys
            )
            for extra in extras:
                common = intersection_keeping_order(common, extra.individual_keys)
        else:
            common = intersection_keeping_order(
                data.individual_keys, pheno.keys, covar.keys
            )
        with timers.phase("LoadGenotypes"):
            data = data.filter(keep_individuals=common)
            stats = data.stats()
        pm = pheno.as_dict()
        y = np.array([pm[k] for k in common])
        x = covar.filter_individuals(common).matrix

        covariance = None
        if kern is not None:
            covariance = self._gwas_covariance([kern] + extras, common, pheno, covar)
        if a.groups or a.group_all:
            return self._grouped_gwas(data, y, x, stats, covariance)
        # the --parallel-gwas analog (gwas.cpp:557-687): each rank tests
        # its share of every SNP chunk; y, X and V stay replicated
        ctx = use_distributed(a, len(common), force=a.parallel_gwas)
        gathers = False
        if covariance is not None:
            lam, u, (vg, ve) = covariance
            if a.gwas_use_null_variances:
                # EMMAX fast path: V^-1 straight from the eigenbasis, in
                # float64 on the device; the GLS runs at the bulk dtype
                v_inv = (u * (1.0 / (vg * lam + ve))) @ u.T
                solver = lambda z: mlm_gwas_fixed_v(z, y, x, v_inv)
            else:
                gathers = ctx is not None  # the retry's warm start is global
                solver = lambda z, *m: mlm_gwas_ml_refit(
                    z, y, x, lam, u, (vg, ve), retry_unfitted=a.gwas_retry_unfitted,
                    mesh_ctx=ctx, n_snps=m[0] if m else None,
                )
        else:
            solver = lambda z: ols_gwas(z, y, x)
        if ctx is not None:
            self.log.message(f"GWAS: SNPs sharded over {ctx.world} ranks")
        with timers.phase("GWAS"):
            res, row_var = _chunked_gwas(
                solver, data, stats.mean, self.device, bulk_dtype(self.device),
                row_variance=a.group_var, ctx=ctx, gathers=gathers,
            )
        with timers.phase("WriteGWAS"):
            self._write_gwas(res, data, covar, common, row_var)
        return res

    def _gwas_covariance(self, kernels: List[Kernel], common, pheno, covar):
        """GWAS::computeCovariance (gwas.cpp:1400-1602): the mixed-model
        covariance kernel and the per-SNP warm-start variances.

        One kernel: the GRM itself.  Several (the GRM and the random-effect
        kernels of addKernelsUsingOptions): an internal dense REML fit
        builds V = sum(sigma2_i K_i) + sigma2_E I, scaled by
        1/sum(sigma2_genetic) (gwas.cpp:1582-1596).  Either way the result
        is diagonalized ONCE, the null fit runs on the O(n) diagonal fast
        path, and every per-SNP ML refit reuses the same eigenbasis
        (gwas.cpp:1509-1595 + 189-209).

        Returns (eigenvalues, eigenvectors, (v_genetic, v_residual)),
        the eigenpairs as float64 tensors on the device."""
        ctx = use_distributed(self.args, len(common))
        kernels = [k.filter_individuals(common) for k in kernels]
        if len(kernels) == 1:
            base = kernels[0]
        else:
            self.log.message(
                f"Computing the GWAS covariance from {len(kernels)} kernels "
                "(internal REML fit, gwas.cpp:1506-1592)"
            )
            sreml = SingleREML(
                kernels, pheno, covar, self.options.reml_options(), device=self.device,
                mesh=ctx, distributed_block=self.args.default_block_size,
            )
            fit = sreml.compute(compute_blue=False)
            if not fit.result.success:
                raise RuntimeError(
                    "REML did not converge, the GWAS covariance cannot be "
                    "computed (gwas.cpp:1563-1569)"
                )
            theta = torch.as_tensor(fit.result.variances, dtype=torch.float64, device=self.device)
            v = sreml.model.compile(self.device).assemble_dense(theta)
            sigma_g = float(fit.result.variances[sreml.model.genetic_variance_indices()].sum())
            base = Kernel(
                name="V",
                type=KernelType.COVARIANCE_MATRIX,
                individual_keys=list(common),
                matrix=v / sigma_g,
            )
        with timers.phase("DiagonalizeGRM"):
            # every rank rotates its SNPs by the whole eigenbasis
            diag = base.diagonalize(mesh=ctx).whole()
        with timers.phase("NullREML"):
            null = SingleREML(
                [diag], pheno, covar, self.options.reml_options(), device=self.device
            ).compute(compute_blue=False)
        vnames = null.result.variance_names
        vg = null.result.variances[vnames.index(f"Var({base.name})")]
        ve = null.result.variances[vnames.index("Var(E)")]
        return diag.eigenvalues, diag.eigenvectors, (vg, ve)

    def _gwas_genotype_grm_list(self):
        """--bfile-grm-list / --bgen-grm-list (gwas.cpp:61-110): a
        2-column 'genotype grm' table; each genotype file runs a GWAS
        corrected by its paired GRM, files sharing a GRM grouped together
        so the covariance loads once."""
        a = self.args
        list_path = a.bfile_grm_list or a.bgen_grm_list
        is_bgen = bool(a.bgen_grm_list)
        pairs = []
        with open(list_path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    pairs.append((parts[0], parts[1]))
        if len({g for g, _ in pairs}) != len(pairs):
            raise ValueError(f"repeated genotype file in [ {list_path} ] (gwas.cpp:102)")
        pairs.sort(key=lambda p: p[1])  # same-GRM files together
        saved = (a.bfile, a.bgen, a.grm, a.bfile_grm_list, a.bgen_grm_list, a.out)
        a.bfile_grm_list = a.bgen_grm_list = None
        outs = []
        try:
            for geno, grm in pairs:
                if is_bgen:
                    a.bfile, a.bgen = None, geno
                else:
                    a.bfile, a.bgen = geno, None
                a.grm = grm
                a.out = f"{saved[5]}.{geno.replace('/', '_')}"
                outs.append(self.make_gwas())
        finally:
            (a.bfile, a.bgen, a.grm, a.bfile_grm_list, a.bgen_grm_list, a.out) = saved
        return outs

    def _grouped_gwas(self, data, y, x, stats, covariance=None):
        """Grouped GWAS (computeGroupedGWAS, gwas.cpp:314-478): joint
        per-group fits — OLS with the F-test GROUPPV, or, with a GRM, ML
        refits under the mixed-model covariance with the chi2-LRT GROUPPV
        (gwas.cpp:787-914 + 940-957) — plus optional per-individual group
        effects.  The raw dosages are decoded on the device once."""
        a = self.args
        grouping = by_group_file(data, a.groups) if a.groups else by_all(data)
        # --parallel-gwas: each rank fits its share of every size bucket
        # (the grouped-communicator path, gwas.cpp:557-687), and every
        # rank receives all results and group effects
        ctx = use_distributed(a, len(y), force=a.parallel_gwas)
        if ctx is not None:
            self.log.message(f"grouped GWAS: groups sharded over {ctx.world} ranks")
        with timers.phase("LoadGenotypes"):
            rows = CenteredRows.from_data(data, self.device)
        with timers.phase("GWAS"):
            results, effects = grouped_gwas(
                rows, data.snp_names, grouping, y, x,
                significance_threshold=a.significance_threshold,
                correlation_threshold=a.snp_corr_threshold,
                compute_effects=a.group_effects,
                covariance=covariance,
                mesh_ctx=ctx,
            )
            # correlated-SNP removal (getLessSignificantCorrelatedSNPs per
            # group, gwas.cpp:391 + storeResults' intersection with the
            # significant set, gwas.cpp:1137-1152)
            flagged = flag_correlated_in_groups(
                rows, data.snp_names, results, a.snp_corr_threshold, mesh_ctx=ctx
            )
        del rows
        name_to_i = {s.name: i for i, s in enumerate(data.snps)}
        c = x.shape[1]
        significant_set: set = set()
        with timers.phase("WriteGWAS"):
            with result_open(a.out + ".multi.gwas.snps") as fh:
                fh.write("GROUP SNP ALLELE MEAN STDEV BETA NBETA SE PV GROUPPV"
                         + (" GROUPVAR\n" if a.group_var else "\n"))
                for group, res in results.items():
                    for j, nm in enumerate(res.snp_names):
                        i = name_to_i[nm]
                        line = (
                            f"{group} {nm} {data.snps[i].allele2} {stats.mean[i]:.3g} "
                            f"{stats.std[i]:.3g} {res.beta[c + j]:.8g} "
                            f"{res.beta[c + j] / stats.std[i]:.5g} "
                            f"{res.se[c + j]:.8g} {res.p[c + j]:.6g} "
                            f"{res.f_p_value:.6g}"
                        )
                        if a.group_var:
                            line += f" {res.group_variance:.6g}"
                        fh.write(line + "\n")
                        if res.p[c + j] < a.significance_threshold:
                            significant_set.add(nm)
            if effects is not None:
                effects.save(a.out + ".effects")
            correlated_significant = sorted(flagged & significant_set)
            if correlated_significant:
                self.log.message(f"{len(correlated_significant)} correlated SNPs removed.")
                with result_open(a.out + ".gwas.correlatedSNPs") as fh:
                    for nm in correlated_significant:
                        fh.write(nm + "\n")
            unfitted = [(g, s) for g, r in results.items() for s in r.dropped_snps]
            if unfitted:
                with result_open(a.out + ".multi.gwas.unfitted") as fh:
                    for g, s in unfitted:
                        fh.write(f"{g} {s}\n")
        self.log.message(
            f"grouped GWAS stored at [ {a.out}.multi.gwas.snps ] ({len(results)} groups)"
        )
        return results

    def make_recursive_gwas(self):
        """--rgwas (gwas.cpp:239-284): grouped fits of consecutive SNPs,
        keep the significant, regroup, until the set stops changing; under
        the mixed-model covariance when a GRM is given (computeGLM
        dispatch, gwas.cpp:690-700)."""
        a = self.args
        with timers.phase("LoadGenotypes"):
            data = self.load_genotype()
        pheno = self.load_phenotypes()[0]
        covar = self.load_covariate(pheno.keys)
        kern = None
        if a.grm:
            with timers.phase("LoadGRM"):
                kern = self.load_grm(allow_compute=False)
            common = intersection_keeping_order(
                kern.individual_keys, pheno.keys, covar.keys, data.individual_keys
            )
        else:
            common = intersection_keeping_order(data.individual_keys, pheno.keys, covar.keys)
        with timers.phase("LoadGenotypes"):
            data = data.filter(keep_individuals=common)
            rows = CenteredRows.from_data(data, self.device)
        pm = pheno.as_dict()
        y = np.array([pm[k] for k in common])
        x = covar.filter_individuals(common).matrix
        covariance = None
        if kern is not None:
            covariance = self._gwas_covariance([kern], common, pheno, covar)
        ctx = use_distributed(a, len(y), force=a.parallel_gwas)
        if ctx is not None:
            self.log.message(f"recursive GWAS: groups sharded over {ctx.world} ranks")
        with timers.phase("GWAS"):
            significant, results = recursive_gwas(
                rows, data.snp_names, y, x,
                group_size=a.rgwas_group_size,
                significance_threshold=a.significance_threshold,
                max_iterations=a.rgwas_maxit,
                iteration_thresholds=a.rgwas_thresholds,
                max_fit_ratio=a.rgwas_ratio,
                covariance=covariance,
                mesh_ctx=ctx,
            )
        with timers.phase("WriteGWAS"):
            with result_open(a.out + ".rgwas") as fh:
                fh.write("SNP\n")
                for s in significant:
                    fh.write(s + "\n")
        self.log.message(
            f"recursive GWAS stored at [ {a.out}.rgwas ] ({len(significant)} significant SNPs)"
        )
        return significant

    def _write_gwas(self, res, data: Union[PlinkData, BgenData], covar, common, row_var=None):
        """Write .gwas.snps / .gwas.mean / .gwas.discrete /
        .gwas.quantitative (storeResults, gwas.cpp:1036-1154).

        In the reference's single-SNP GWAS every SNP is its own "group"
        keyed by SNP name in a std::map (gwas.cpp:532-535): rows come out
        in LEXICOGRAPHIC SNP-name order, the GROUP column is the SNP name,
        the per-kind covariate files carry that SNP's own covariate
        estimates, and GROUPPV (gwas.cpp:916-967) is always present.
        Unfitted SNPs never enter the map, so they appear only in
        .gwas.unfitted."""
        a = self.args
        stats = data.stats()
        x_names = covar.filter_individuals(common).column_names
        kinds = {"mean": [], "discrete": [], "quantitative": []}
        for i, name in enumerate(x_names):
            if name.startswith("discrete"):
                kinds["discrete"].append((name, i))
            elif name.startswith("quantitative"):
                kinds["quantitative"].append((name, i))
            else:
                kinds["mean"].append((name, i))
        fitted = (
            res.converged
            if res.converged is not None
            else np.ones(len(data.snps), dtype=bool)
        )
        # std::map iteration = SNP names sorted lexicographically
        order = sorted(
            (i for i in range(len(data.snps)) if fitted[i]),
            key=lambda i: data.snps[i].name,
        )
        for kind, entries in kinds.items():
            with result_open(f"{a.out}.gwas.{kind}") as fh:
                fh.write("GROUP NAME BETA SE PV\n")
                for i in order:
                    group = data.snps[i].name
                    for name, j in entries:
                        fh.write(
                            f"{group} {name} {res.cov_beta[i, j]:.8g} "
                            f"{res.cov_se[i, j]:.8g} {res.cov_p[i, j]:.6g}\n"
                        )
        group_p = res.group_p if res.group_p is not None else res.snp_p
        group_var = None
        if a.group_var and row_var is not None:
            # GROUPVAR (computeGroupVariance, gwas.cpp:970-1034): the
            # variance over individuals of this SNP's fitted effect
            # g*beta (ddof=1, computeVariance auxiliar.cpp:410-465)
            group_var = res.snp_beta**2 * row_var
        significant = []
        with result_open(a.out + ".gwas.snps") as fh:
            fh.write(
                "GROUP SNP ALLELE MEAN STDEV BETA NBETA SE PV GROUPPV"
                + (" GROUPVAR\n" if group_var is not None else "\n")
            )
            for i in order:
                snp = data.snps[i]
                line = (
                    f"{snp.name} {snp.name} {snp.allele2} "
                    f"{stats.mean[i]:.3g} "
                    f"{stats.std[i]:.3g} {res.snp_beta[i]:.8g} "
                    f"{res.snp_beta[i] / stats.std[i]:.5g} "
                    f"{res.snp_se[i]:.8g} {res.snp_p[i]:.6g} "
                    f"{group_p[i]:.6g}"
                )
                if group_var is not None:
                    line += f" {group_var[i]:.6g}"
                fh.write(line + "\n")
                if res.snp_p[i] < a.significance_threshold:
                    significant.append(snp.name)
        # non-converged per-SNP ML fits (gwas.cpp:546-554)
        if res.converged is not None and not res.converged.all():
            with result_open(a.out + ".gwas.unfitted") as fh:
                for i, snp in enumerate(data.snps):
                    if not res.converged[i]:
                        fh.write(snp.name + "\n")
        self.log.message(
            f"GWAS results stored at [ {a.out}.gwas.* ] "
            f"({len(significant)} significant SNPs)"
        )

    # ------------------------------------------------- multi-phenotype ---
    def make_mp_residuals(self):
        """--mpresiduals (analysis.cpp:471-477, mpresiduals.cpp:46-192):
        the GRM (stored, or built in line by K1), diagonalized once, and
        one diagonal REML fit per phenotype column."""
        a = self.args
        with timers.phase("LoadGRM" if (a.grm or a.gcta_grms_gz) else "ComputeGRM"):
            kern = self.load_grm()
        columns = (
            [int(c) for c in a.pheno_cols.split(",")]
            if a.pheno_cols
            else list(range(1, n_phenotype_columns(a.pheno) + 1))
        )
        phenos = self.load_phenotypes(columns)
        covar = self.load_covariate(phenos[0].keys)
        lm = compute_mp_residuals(
            kern, phenos, [f"pheno_{c}" for c in columns], covar, self.options.reml_options(),
            mesh=use_distributed(a, kern.n),
        )
        with timers.phase("WriteREML"):
            lm.save(a.out + ".residuals")
        self.log.message(f"residuals stored at [ {a.out}.residuals.* ]")
        return lm

    def make_mp_gwas(self):
        """--mpgwas (analysis.cpp:458-469, gwasmp.cpp:96-366).  With
        --bfile-residuals-list / --bgen-residuals-list, a 2-column
        'genotype residuals-prefix' table runs one pass per pair
        (loadGenotypeResidualFiles, gwasmp.cpp:38-90)."""
        a = self.args
        list_path = a.bfile_residuals_list or a.bgen_residuals_list
        if not list_path:
            return self._mp_gwas_one(a.out + ".residuals")
        is_bgen = bool(a.bgen_residuals_list)
        pairs = []
        with open(list_path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 2:
                    pairs.append((parts[0], parts[1]))
        saved = (a.bfile, a.bgen, a.out)
        outs = []
        try:
            for geno, res_prefix in pairs:
                if is_bgen:
                    a.bfile, a.bgen = None, geno
                else:
                    a.bfile, a.bgen = geno, None
                a.out = f"{saved[2]}.{geno.replace('/', '_')}"
                outs.append(self._mp_gwas_one(res_prefix))
        finally:
            a.bfile, a.bgen, a.out = saved
        return outs

    def mp_gwas_scan(self, residuals_prefix: str):
        """One genotype set against one residual matrix, without writing:
        (MpGwasResults, the filtered genotype data).  The residual columns
        are centered once and moved to the device once; the SNPs go in
        chunks of `gwas_chunk_snps` of the common individuals, centered
        on the device (gwasmp.cpp's per-file loop).

        Spans (runtime/timers.py): mp.residuals (the matrix loaded,
        filtered to the individuals shared with the genotypes, centered
        and moved to the device), inside LoadGenotypes; each chunk's
        gwas.chunk holds mp_gwas's spans; counter mp.chunk_snps (the
        chunk chosen, once a pass)."""
        a = self.args
        dtype = bulk_dtype(self.device)
        with timers.phase("LoadGenotypes"):
            data = self.load_genotype()
            with timers.span("mp.residuals"):
                lm = LabeledMatrix.load(residuals_prefix)
                common = intersection_keeping_order(lm.row_labels, data.individual_keys)
                residuals = DeviceResiduals.upload(
                    lm.filter(keep_rows=common).center_columns(), self.device, dtype)
                del lm
            data = data.filter(keep_individuals=common)
            mean = data.stats().mean
        with timers.phase("GWAS"):
            chunk = gwas_chunk_snps(data.n_individuals)
            timers.count("mp.chunk_snps", chunk)
            res = MpGwasResults.concatenate(_map_snp_chunks(
                lambda z, names, *_: mp_gwas(z.to(dtype), names, residuals),
                data, mean, self.device, chunk=chunk,
                ctx=use_distributed(a, len(common), force=a.parallel_gwas),
            ))
        return res, data

    def _mp_gwas_one(self, residuals_prefix: str):
        """One genotype set against one residual matrix (`mp_gwas_scan`),
        then its .mpgwas and .multipheno.gwas.snps files."""
        a = self.args
        res, data = self.mp_gwas_scan(residuals_prefix)
        with timers.phase("WriteGWAS"):
            res.write(a.out)
            self._write_mpgwas_reference_file(res, data)
        self.log.message(
            f"mpgwas results stored at [ {a.out}.mpgwas / {a.out}.multipheno.gwas.snps ]"
        )
        return res

    def _write_mpgwas_reference_file(self, res, data: Union[PlinkData, BgenData]):
        """The reference's wide per-SNP table
        (storeResultsMultiplePhenotype, gwasmp.cpp:752-813): one row per
        SNP in lexicographic (std::map) order with NBETA-<pheno>
        NSE-<pheno> PV-<pheno> triplets, effects and SEs divided by the
        SNP's standard deviation."""
        a = self.args
        stats = data.stats()
        with result_open(a.out + ".multipheno.gwas.snps") as fh:
            header = "SNP ALLELE MEAN STDEV"
            for label in res.phenotype_names:
                header += f" NBETA-{label} NSE-{label} PV-{label}"
            fh.write(header + "\n")
            for i in sorted(range(len(data.snps)), key=lambda i: data.snps[i].name):
                snp = data.snps[i]
                sd = stats.std[i]
                line = f"{snp.name} {snp.allele2} {stats.mean[i]:.3g} {sd:.3g}"
                for j in range(len(res.phenotype_names)):
                    line += (
                        f" {res.beta[i, j] / sd:.5g}"
                        f" {res.se[i, j] / sd:.5g}"
                        f" {res.p[i, j]:.6g}"
                    )
                fh.write(line + "\n")

    # ------------------------------------------------------------ iGWAS ---
    def make_igwas(self):
        """--igwas (igwas.cpp:102-200): SNP as the outcome.

        Base covariates come from --covar/--qcovar, TESTED covariates
        from --igwas-covar/--igwas-qcovar (no mean column,
        igwas.cpp:134-140).  Without a GRM the tested covariates are
        required (igwas.cpp:27-30) and the per-SNP answer is the joint
        F-test of the tested block; with a GRM the tested covariates are
        rejected (igwas.cpp:70-76) and the answer is the chi2 LRT of the
        genetic variance from per-SNP ML refits, whose moments K3
        computes on the card."""
        a = self.args
        with timers.phase("LoadGenotypes"):
            data = self.load_genotype()
        covar = read_covariates(a.covar, a.qcovar, default_keys=data.individual_keys)
        test_covar = None
        if a.igwas_covar or a.igwas_qcovar:
            test_covar = read_covariates(a.igwas_covar, a.igwas_qcovar, include_mean=False)
        elif not a.grm:
            raise ValueError(
                "a file defining the covariates to test is expected "
                "(--igwas-covar/--igwas-qcovar, igwas.cpp:27-30)"
            )
        common = intersection_keeping_order(data.individual_keys, covar.keys)
        if test_covar is not None:
            common = intersection_keeping_order(common, test_covar.keys)
            test_covar = test_covar.filter_individuals(common)
        with timers.phase("LoadGenotypes"):
            data = data.filter(keep_individuals=common)
            stats = data.stats()
        covar = covar.filter_individuals(common)
        covariance = None
        if a.grm:
            # igwas covariance mirrors the GWAS machinery
            # (IGWAS::computeCovariance, igwas.cpp:1223-1420): the GRM
            # diagonalized once; every SNP-as-outcome test is then a
            # per-SNP ML variance refit in the eigenbasis
            # (igwas.cpp:575-720) — NOT a fixed V = K + I
            with timers.phase("LoadGRM"):
                kern = self.load_grm(allow_compute=False).filter_individuals(common)
            with timers.phase("DiagonalizeGRM"):
                diag = kern.diagonalize(mesh=use_distributed(a, kern.n)).whole()
            covariance = (diag.eigenvalues, diag.eigenvectors)
            del kern

        def run_igwas(z, names, *_):
            return igwas(
                z, names, covar.matrix, covar.column_names,
                test_x=None if test_covar is None else test_covar.matrix,
                test_names=None if test_covar is None else test_covar.column_names,
                covariance=covariance,
                initial_h2=a.initial_h2,
            )

        with timers.phase("GWAS"):
            # the rows stay float64 for the per-SNP start variances;
            # igwas takes them to the bulk dtype
            res = IGwasResults.concatenate(_map_snp_chunks(
                run_igwas, data, stats.mean, self.device,
                ctx=use_distributed(a, len(common), force=a.parallel_gwas),
            ))
        with timers.phase("WriteGWAS"):
            res.write(a.out)
            self._write_igwas_reference_files(res, data, stats)
        self.log.message(f"inverse GWAS stored at [ {a.out}.igwas / {a.out}.gwas.* ]")
        return res

    def _write_igwas_reference_files(self, res, data: Union[PlinkData, BgenData], stats):
        """The reference's IGWAS result files (IGWAS::storeResults,
        igwas.cpp:854-967): the .gwas.mean/.discrete/.quantitative files
        carry the BASE covariate estimates per SNP-group; the .gwas.snps
        rows print NA for the SNP effect columns (the SNP is the outcome)
        with the per-SNP test in GROUPPV."""
        a = self.args
        kinds = {"mean": [], "discrete": [], "quantitative": []}
        for j, name in enumerate(res.covariate_names[: res.n_base]):
            if name.startswith("discrete"):
                kinds["discrete"].append((name, j))
            elif name.startswith("quantitative"):
                kinds["quantitative"].append((name, j))
            else:
                kinds["mean"].append((name, j))
        fitted = (
            res.converged
            if res.converged is not None
            else np.ones(len(data.snps), dtype=bool)
        )
        order = sorted(
            (i for i in range(len(data.snps)) if fitted[i]),
            key=lambda i: data.snps[i].name,
        )
        for kind, entries in kinds.items():
            with result_open(f"{a.out}.gwas.{kind}") as fh:
                fh.write("GROUP NAME BETA SE PV\n")
                for i in order:
                    group = data.snps[i].name
                    for name, j in entries:
                        fh.write(
                            f"{group} {name} {res.beta[i, j]:.8g} "
                            f"{res.se[i, j]:.8g} {res.p[i, j]:.6g}\n"
                        )
        group_p = res.group_p
        with result_open(a.out + ".gwas.snps") as fh:
            fh.write("GROUP SNP ALLELE MEAN STDEV BETA NBETA SE PV GROUPPV\n")
            for i in order:
                snp = data.snps[i]
                gp = f"{group_p[i]:.6g}" if group_p is not None else "NA"
                fh.write(
                    f"{snp.name} {snp.name} {snp.allele2} "
                    f"{stats.mean[i]:.3g} {stats.std[i]:.3g} "
                    f"NA NA NA NA {gp}\n"
                )
        if res.converged is not None and not res.converged.all():
            with result_open(a.out + ".gwas.unfitted") as fh:
                for i, snp in enumerate(data.snps):
                    if not res.converged[i]:
                        fh.write(snp.name + "\n")

    # ------------------------------------------------------------- GLMM ---
    def make_glmm(self):
        """--glmm (glmm.cpp, experimental as in the reference main.cpp:200).

        The covariance GLMM samples from is the REML-PREPARED model
        (SingleREML hands its prepared reml to GLMM, singlereml.cpp:193-200;
        GLMM::GLMM assembles V from the prepare-time initial variances,
        glmm.cpp:40-55): all kernels + E, with initial variances
        h2/(1-h2)-split of the OLS residual variance (reml.cpp:1100-1131).
        V is assembled, inverted and sampled from in float64 on the
        device."""
        a = self.args
        stored = a.grm or a.gcta_grms_gz
        with timers.phase("LoadGRM" if stored else "ComputeGRM"):
            kern = self.load_grm()
        pheno = self.load_phenotypes()[0]
        covar = self.load_covariate(pheno.keys)
        kernels = [kern] + self.extra_kernels(kern)
        common = intersection_keeping_order(kern.individual_keys, pheno.keys, covar.keys)
        for extra in kernels[1:]:
            common = intersection_keeping_order(common, extra.individual_keys)
        kernels = [k.filter_individuals(common) for k in kernels]
        pm = pheno.as_dict()
        raw = np.array([pm[k] for k in common])
        y = (raw == raw.max()).astype(np.float64)  # 1/2 case coding -> 0/1
        x = covar.filter_individuals(common).matrix
        with timers.phase("GLMM"):
            model = build_variance_model(
                [k.dense().to(torch.float64) for k in kernels],
                [k.name for k in kernels],
                [initial_residual_variance(y, x)],
                [a.initial_h2],
            )
            theta = torch.as_tensor(model.initial_theta(), device=self.device)
            v = model.compile().assemble_dense(theta)
            del kernels, kern, model
            result = GLMM(y, x, v, seed=a.random_seed).fit()
        with result_open(a.out + ".glmm") as fh:
            fh.write("NAME BETA SE\n")
            names = covar.filter_individuals(common).column_names
            for name, b, se in zip(names, result.betas, result.betas_se):
                fh.write(f"{name} {b:.8g} {se:.8g}\n")
        self.log.message(f"GLMM results stored at [ {a.out}.glmm ]")
        return result

    # ---------------------------------------------------- small workflows ---
    def make_simulate(self):
        """--simulate (analysis.cpp:181-192): host numpy, as in JAX."""
        a = self.args
        data = self.load_genotype()
        result = simulate_phenotypes(
            data,
            read_causal_snps(a.effect_sizes),
            h2=a.simu_h2,
            binary=a.simu_binary,
            prevalence=a.prevalence,
            seed=a.random_seed,
        )
        result.write(a.out)
        self.log.message(f"simulation stored at [ {a.out}.simulated.* ]")
        return result

    def make_predict(self):
        """--predict (analysis.cpp:194-231): host numpy, as in JAX."""
        a = self.args
        data = self.load_genotype()
        result = predict_phenotypes(data, read_snp_effects(a.snp_effects))
        result.write(a.out)
        self.log.message(
            f"predictions stored at [ {a.out}.predicted.phenos ] "
            f"({result.n_snps_used} SNPs, {result.n_flipped} flipped)"
        )
        return result

    def make_accuracy_by_snp(self):
        """--accuracy-by-snp (accuracybysnp.cpp:67-303)."""
        a = self.args
        data = self.load_genotype()
        effects = read_snp_effects(a.snp_effects)
        pheno = self.load_phenotypes()[0]
        common = intersection_keeping_order(data.individual_keys, pheno.keys)
        data = data.filter(keep_individuals=common)
        pm = pheno.as_dict()
        res = compute_accuracy_by_snp(data, effects, np.array([pm[k] for k in common]))
        res.write(a.out, data.filter(keep_snps=res.snp_names).stats())
        self.log.message(
            f"accuracies stored at [ {a.out}.snps.accuracies ] "
            f"(total {res.total_accuracy:.4g}, filtered "
            f"{res.filtered_accuracy:.4g} with {len(res.filtered_snps)} SNPs)"
        )
        return res

    def make_cov_predict(self):
        """--cov-predict (makePredictCovarPhenotype, analysis.cpp:436-456):
        per-individual covariate contribution from stored effects,
        written as .covars.predicted.phenos."""
        a = self.args
        if not (a.covar or a.qcovar):
            raise ValueError("--cov-predict needs --covar and/or --qcovar")
        values = load_effect_prediction(
            a.covar,
            a.qcovar,
            a.covar_effects,
            a.qcovar_effects,
            force_unestimated=a.force_use_unestimated_values,
        )
        with result_open(a.out + ".covars.predicted.phenos") as fh:
            fh.write("FID IID CPHENO\n")
            for key, value in values.items():
                fid, iid = key.split("@", 1)
                fh.write(f"{fid} {iid} {value:.8g}\n")
        self.log.message(
            f"covariate predictions stored at "
            f"[ {a.out}.covars.predicted.phenos ] ({len(values)} individuals)"
        )
        return values

    def make_snp_stats(self):
        """--snp-stats."""
        a = self.args
        data = self.load_genotype()
        stats = data.stats()
        with result_open(a.out + ".snpstats") as fh:
            fh.write("SNP CHR BP A1 A2 NONMISSING P1 P2 STD\n")
            for i, s in enumerate(data.snps):
                fh.write(
                    f"{s.name} {s.chromosome} {s.position_bp} {s.allele1} "
                    f"{s.allele2} {stats.n_nonmissing[i]} {stats.p1[i]:.6g} "
                    f"{stats.p2[i]:.6g} {stats.std[i]:.6g}\n"
                )
        self.log.message(f"SNP stats stored at [ {a.out}.snpstats ]")

    def make_group_effects(self):
        """--effects (makeEffectsAnalysis, analysis.cpp:262-415):
        cross-group correlations, individual covariances + PCA (float64
        eigh on the device), and distance-aware correlated-group
        filtering; or, with --effects-pair-files, crossed correlations
        between two sets."""
        a = self.args

        def write_pca(lm, prefix):
            w, loadings = pca_of_labeled_matrix(lm, a.num_eval, device=self.device)
            with result_open(prefix + ".pca.eigenvalues") as fh:
                total = max(float(np.sum(np.abs(w))), 1e-300)
                fh.write("EIGENVALUE VARIANCE_EXPLAINED\n")
                for val in w:
                    fh.write(f"{val:.8g} {val / total:.8g}\n")
            loadings.save(prefix + ".pca.loadings")

        if a.effects_pair_files:
            if len(a.effects_pair_files) % 2:
                raise ValueError("--effects-pair-files needs an even count")
            g1 = GroupEffects.load(a.effects_pair_files[0::2])
            g2 = GroupEffects.load(a.effects_pair_files[1::2])
            corr = crossed_correlations(g1, g2)
            corr.save(a.out + ".gene.crossed.correlations")
            self.log.message(
                f"crossed correlations stored at [ {a.out}.gene.crossed.correlations.* ]"
            )
            return corr
        if not a.effects_files:
            raise ValueError("--effects needs --effects-files (or --effects-pair-files)")
        ge = GroupEffects.load(a.effects_files)
        if a.keep_groups:
            with open(a.keep_groups) as fh:
                keep = {ln.strip() for ln in fh if ln.strip()}
            ge = GroupEffects(ge.effects.filter(
                keep_cols=[c for c in ge.effects.col_labels if c in keep]
            ))
        if a.keep:
            with open(a.keep) as fh:
                keep = {
                    parts[0] + "@" + parts[1]
                    for parts in (ln.split() for ln in fh)
                    if len(parts) >= 2
                }
            ge = GroupEffects(ge.effects.filter(
                keep_rows=[r for r in ge.effects.row_labels if r in keep]
            ))
        ge.correlations_between_groups().save(a.out + ".gene.correlations.unfiltered")
        write_pca(ge.covariances_between_individuals(), a.out + ".indiv.covariances.unfiltered")
        if a.groups_positions:
            positions = read_group_positions(a.groups_positions)
            filt = ge.filter_correlated_groups(0.1, positions, a.group_min_distance)
            tag = str(a.group_min_distance)
            filt.correlations_between_groups().save(a.out + f".gene.correlations.{tag}")
            write_pca(filt.covariances_between_groups(), a.out + f".gene.covariances.{tag}")
            write_pca(filt.covariances_between_individuals(),
                      a.out + f".indiv.covariances.{tag}")
        self.log.message(f"group-effects analyses stored at [ {a.out}.* ]")
        return ge

    # --------------------------------------------------------- dispatch ---
    def run(self):
        dispatch = {
            "makeGRM": self.make_grm,
            "makeGRMMostRelated": self.make_grm_most_related,
            "GWAS": self.make_gwas,
            "filterMatrix": self.make_filter_matrix,
            "addGRMs": self.make_add_grms,
            "REML": self.make_reml,
            "PCA": self.make_pca,
            "bivarREML": self.make_multi_reml,
            "multiREML": self.make_multi_reml,
            "recursiveGWAS": self.make_recursive_gwas,
            "multiplePhenotypeResiduals": self.make_mp_residuals,
            "multiplePhenotypeGWAS": self.make_mp_gwas,
            "iGWAS": self.make_igwas,
            "simulate": self.make_simulate,
            "predict": self.make_predict,
            "snpStats": self.make_snp_stats,
            "GLMM": self.make_glmm,
            "groupEffects": self.make_group_effects,
            "accuracyBySNP": self.make_accuracy_by_snp,
            "predictCovarPhenotype": self.make_cov_predict,
        }
        if self.args.check:
            self.log.message("Option check finished (--check): no analysis run.")
            return None
        analysis = self.options.analysis
        if analysis is None:
            raise ValueError("no analysis specified (e.g. --make-grm, --reml, --gwas)")
        return dispatch[analysis]()


def main(argv=None):
    """The CLI: parse, pick the device (the card unless
    DISSECT_TPU_TORCH_DEVICE asks for the CPU), run one analysis, and
    return what it returned (e.g. a SingleREMLOutput for --reml)."""
    configure_precision()
    options = Options.parse(argv)
    device = cli_device()
    log = get_logger()
    failed = True
    try:
        # the run's mesh before anything is logged or written: only rank
        # 0 does either (a multi-rank launch is torchrun's; a failed
        # rank stops the launch, its peers' collectives fail with it)
        ctx = startup_runtime(options.args.mesh, device)
        log.attach_file(options.args.out)
        log.verbose = options.args.verbose
        options.echo(log)
        set_zout(options.args.zout)
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
        log.message(f"Device: {device} ({name})")
        if ctx is not None and ctx.world > 1:
            log.message(mesh_summary(ctx))
        timers.reset()  # in-process sequential runs must not accumulate
        with timers.phase("Total"):
            output = Analysis(options, device).run()
        mem = timers.process_memory()
        total = timers.elapsed.get("Total", 0.0)
        log.message(
            f"Analysis finished in {total:.2f}s"
            + (f" (peak RSS {mem['VmHWM']})" if "VmHWM" in mem else "")
        )
        failed = False
    finally:
        log.close()
        shutdown_runtime(failed)
    return output
