"""Analysis dispatcher — the workflow driver of the ported analyses.

Parity: Analysis (analysis.cpp:43-548) + main.cpp's dispatch chain
(main.cpp:101-234) + the loaders-from-options in auxiliar.h:246-310.
Port of the pieces of dissect_tpu/analysis/dispatcher.py on the
`--make-grm` -> `--gwas [--grm]` path (PLINK or BGEN input) and of the
GRM family (`--make-grm-mr`, `--add-grms`, `--filter-matrix`,
`--gcta-grms-gz`, `--grm-epi`), on one device.  Every other analysis
raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from dissect_tpu_torch.gwas.mlm import mlm_gwas_ml_refit
from dissect_tpu_torch.gwas.ols import GwasResults, ols_gwas
from dissect_tpu_torch.io import grm_io
from dissect_tpu_torch.io.bed import PlinkData, read_plink
from dissect_tpu_torch.io.bgen import BgenData, read_bgen
from dissect_tpu_torch.io.covariate import read_covariates
from dissect_tpu_torch.io.ids import intersection_keeping_order
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.io.phenotype import n_phenotype_columns, read_phenotype
from dissect_tpu_torch.model.kernels import Kernel, KernelType, grm_from_plink
from dissect_tpu_torch.reml.single import SingleREML
from dissect_tpu_torch.runtime.device import check_single_device, cli_device
from dissect_tpu_torch.runtime.dtypes import GRM_DTYPE, bulk_dtype, configure_precision
from dissect_tpu_torch.runtime.log import get_logger, result_open, set_zout
from dissect_tpu_torch.runtime.options import Options
from dissect_tpu_torch.runtime.timers import timers

# SNPs per device dispatch for genome-scale streaming (bounds host and
# device memory; the batched analog of the reference's per-file loop)
GWAS_CHUNK_SNPS = 65536


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to dissect_tpu_torch yet (ROADMAP.md queue 1, {item})"
    )


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _centered_genotypes(dosage: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Missing-zeroed mean-centered rows of an (m, N) chunk, for both hard
    calls (int8, -1 missing) and imputed dosages (float, NaN missing), in
    float64 on the chunk's device; the caller casts to its bulk dtype.
    Centering on the device keeps the host at the raw chunk instead of
    M x N float64."""
    if dosage.is_floating_point():
        observed = torch.isfinite(dosage)
    else:
        observed = dosage >= 0
    centered = dosage.to(torch.float64) - mean.to(torch.float64)[:, None]
    return torch.where(observed, centered, torch.zeros_like(centered))


def _chunked_gwas(fn, data: Union[PlinkData, BgenData], mean: np.ndarray, device, dtype,
                  chunk: Optional[int] = None, row_variance: bool = False):
    """Run a per-SNP GWAS solver over SNP blocks and concatenate — bounds
    device and host memory at genome scale (gwas.cpp:126-312).  Each
    block's raw dosages are uploaded and centered on `device`.

    Returns (results, per-SNP variance of the centered rows or None)."""
    chunk = chunk or GWAS_CHUNK_SNPS
    parts: List[GwasResults] = []
    variances = []
    for start in range(0, data.n_snps, chunk):
        stop = min(start + chunk, data.n_snps)
        dosage = torch.as_tensor(data.decode_chunk(start, stop)).to(device)
        mu = torch.as_tensor(mean[start:stop]).to(device)
        z = _centered_genotypes(dosage, mu)
        if row_variance:
            variances.append(_host(torch.var(z, dim=1, unbiased=True)))
        parts.append(fn(z.to(dtype)))
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
            data = read_bgen(a.bgen)
        elif a.bfile:
            data = read_plink(a.bfile)
        elif a.bfile_list:
            with open(a.bfile_list) as fh:
                prefixes = [ln.strip() for ln in fh if ln.strip()]
            data = read_plink(prefixes[0])
            for prefix in prefixes[1:]:
                data = data.append_snps(read_plink(prefix))
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
                diag = kern.diagonalize()
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
        grm_io.write_grm_diagonalized(
            self.args.out,
            _host(diag.eigenvalues),
            _host(diag.eigenvectors),
            diag.individual_keys,
            diag.snp_names,
        )

    @timers.timed("WriteGRM")
    def _write_grm(self, kern: Kernel, prefix: str):
        grm_io.write_grm(
            prefix, _host(kern.matrix), _host(kern.counts), kern.individual_keys, kern.snp_names
        )

    def _check_single_kernel(self):
        """The GWAS covariance from the GRM alone: the extra random-effect
        kernels need the dense REML fit of the covariance
        (gwas.cpp:1506-1592)."""
        a = self.args
        if a.random_effects or a.multirandom_effects or a.sqrt_exp_coord_files:
            raise _not_ported("GWAS with extra random-effect kernels", "item 2")

    def make_gwas(self):
        """--gwas (gwas.cpp:126-312): OLS without a GRM, mixed model with."""
        a = self.args
        if a.bfile_grm_list or a.bgen_grm_list:
            raise _not_ported("--bfile-grm-list / --bgen-grm-list", "item 2")
        if a.groups or a.group_all:
            raise _not_ported("grouped GWAS (--groups / --group-all)", "item 6")
        if a.grm and a.gwas_use_null_variances:
            raise _not_ported("--gwas-use-null-variances (mlm_gwas_fixed_v)", "item 2")
        with timers.phase("LoadGenotypes"):
            data = self.load_genotype()
        pheno = self.load_phenotypes()[0]
        covar = self.load_covariate(pheno.keys)

        kern = None
        if a.grm:
            self._check_single_kernel()
            with timers.phase("LoadGRM"):
                kern = self.load_grm(allow_compute=False)
            common = intersection_keeping_order(
                kern.individual_keys, pheno.keys, covar.keys, data.individual_keys
            )
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

        if kern is not None:
            lam, u, (vg, ve) = self._gwas_covariance(kern, common, pheno, covar)
            solver = lambda z: mlm_gwas_ml_refit(
                z, y, x, lam, u, (vg, ve), retry_unfitted=a.gwas_retry_unfitted
            )
        else:
            solver = lambda z: ols_gwas(z, y, x)
        with timers.phase("GWAS"):
            res, row_var = _chunked_gwas(
                solver, data, stats.mean, self.device, bulk_dtype(self.device),
                row_variance=a.group_var,
            )
        with timers.phase("WriteGWAS"):
            self._write_gwas(res, data, covar, common, row_var)
        return res

    def _gwas_covariance(self, kern: Kernel, common, pheno, covar):
        """GWAS::computeCovariance (gwas.cpp:1400-1602) with one kernel:
        the GRM is diagonalized ONCE, the null fit runs on the O(n)
        diagonal fast path, and every per-SNP ML refit reuses the same
        eigenbasis (gwas.cpp:1509-1595 + 189-209).

        Returns (eigenvalues, eigenvectors, (v_genetic, v_residual)),
        the eigenpairs as float64 tensors on the device."""
        base = kern.filter_individuals(common)
        with timers.phase("DiagonalizeGRM"):
            diag = base.diagonalize()
        with timers.phase("NullREML"):
            null = SingleREML(
                [diag], pheno, covar, self.options.reml_options(), device=self.device
            ).compute()
        vnames = null.result.variance_names
        vg = null.result.variances[vnames.index(f"Var({base.name})")]
        ve = null.result.variances[vnames.index("Var(E)")]
        return diag.eigenvalues, diag.eigenvectors, (vg, ve)

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

    # --------------------------------------------------------- dispatch ---
    def run(self):
        dispatch = {
            "makeGRM": self.make_grm,
            "makeGRMMostRelated": self.make_grm_most_related,
            "GWAS": self.make_gwas,
            "filterMatrix": self.make_filter_matrix,
            "addGRMs": self.make_add_grms,
        }
        not_ported = {
            "REML": "item 2",
            "PCA": "item 3",
            "bivarREML": "item 5",
            "multiREML": "item 5",
            "recursiveGWAS": "item 6",
            "multiplePhenotypeResiduals": "item 7",
            "multiplePhenotypeGWAS": "item 7",
            "iGWAS": "item 7",
            "simulate": "item 8",
            "predict": "item 8",
            "snpStats": "item 8",
            "GLMM": "item 8",
            "groupEffects": "item 8",
            "accuracyBySNP": "item 8",
            "predictCovarPhenotype": "item 8",
        }
        if self.args.check:
            self.log.message("Option check finished (--check): no analysis run.")
            return None
        analysis = self.options.analysis
        if analysis is None:
            raise ValueError("no analysis specified (e.g. --make-grm, --reml, --gwas)")
        if analysis in not_ported:
            raise _not_ported(f"analysis {analysis}", not_ported[analysis])
        return dispatch[analysis]()


def main(argv=None):
    """The CLI: parse, pick the device (the card unless
    DISSECT_TPU_TORCH_DEVICE asks for the CPU), run one analysis."""
    configure_precision()
    options = Options.parse(argv)
    check_single_device(options.args.mesh)
    device = cli_device()
    log = get_logger()
    log.attach_file(options.args.out)
    try:
        log.verbose = options.args.verbose
        options.echo(log)
        set_zout(options.args.zout)
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
        log.message(f"Device: {device} ({name})")
        timers.reset()  # in-process sequential runs must not accumulate
        with timers.phase("Total"):
            Analysis(options, device).run()
        mem = timers.process_memory()
        total = timers.elapsed.get("Total", 0.0)
        log.message(
            f"Analysis finished in {total:.2f}s"
            + (f" (peak RSS {mem['VmHWM']})" if "VmHWM" in mem else "")
        )
    finally:
        log.close()
