"""CLI options — DISSECT-compatible flag surface (a copy of
dissect_tpu/runtime/options.py, so the port parses the same argv).

Parity: options.{h,cpp} — the AnalysisToPerform enum (options.h:34-58)
and the ~150 flags (options.cpp:278-1158), with the same names, typed
getters and Range validation (range.h:27-57), incompatibility checks
and option echo (options.cpp:1229-1664).  Flags implemented by analyses
that are still landing raise a clear NotImplementedError instead of
silently parsing.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from dissect_tpu_torch.reml.engine import REMLOptions


class OptionsError(ValueError):
    pass


def _ranged(type_, lo=None, hi=None):
    """Typed getter with Range bounds (range.h:27-57)."""

    def parse(text):
        v = type_(text)
        if lo is not None and v < lo:
            raise argparse.ArgumentTypeError(f"value {v} below minimum {lo}")
        if hi is not None and v > hi:
            raise argparse.ArgumentTypeError(f"value {v} above maximum {hi}")
        return v

    return parse


ANALYSES = [
    # (flag, dest, help) — mirrors AnalysisToPerform (options.h:34-58)
    ("--make-grm", "makeGRM", "compute the GRM from genotypes"),
    ("--reml", "REML", "single-trait AI-REML variance components"),
    ("--bivar-reml", "bivarREML", "bivariate REML"),
    ("--multi-reml", "multiREML", "multivariate REML"),
    ("--gwas", "GWAS", "per-SNP association (mixed model when a GRM is given)"),
    ("--rgwas", "recursiveGWAS", "recursive grouped GWAS"),
    ("--igwas", "iGWAS", "inverse GWAS (SNP as outcome)"),
    ("--mpgwas", "multiplePhenotypeGWAS", "multi-phenotype residual GWAS"),
    ("--mpresiduals", "multiplePhenotypeResiduals", "precompute mpgwas residuals"),
    ("--pca", "PCA", "principal components of the GRM"),
    ("--simulate", "simulate", "simulate phenotypes from causal effects"),
    ("--predict", "predict", "polygenic phenotype prediction"),
    ("--effects", "groupEffects", "group-effects analysis"),
    ("--glmm", "GLMM", "logistic mixed model (experimental)"),
    ("--snp-stats", "snpStats", "per-SNP allele statistics"),
    ("--accuracy-by-snp", "accuracyBySNP", "prediction accuracy vs SNP removal"),
    ("--filter-matrix", "filterMatrix", "filter a labeled matrix by row/col label files"),
    ("--add-grms", "addGRMs", "sum the GRMs in --grm-list into one"),
    ("--cov-predict", "predictCovarPhenotype",
     "predict the covariate contribution to phenotypes from stored "
     "covariate effects (analysis.cpp:436-456)"),
    ("--make-grm-mr", "makeGRMMostRelated",
     "compute the GRM, store it, and also store the subset of "
     "individuals with relatedness outside [--mostr-lower-thr, "
     "--mostr-upper-thr] (makeGRMAndStoreMostRelated, "
     "analysis.cpp:113-135)"),
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dissect_tpu_torch",
        description="Genomic mixed-model engine on PyTorch/CUDA "
        "(capabilities of DISSECT; port of dissect_tpu)",
    )
    g = p.add_argument_group("analysis")
    for flag, dest, help_ in ANALYSES:
        g.add_argument(flag, dest=dest, action="store_true", help=help_)

    d = p.add_argument_group("data")
    d.add_argument("--bfile", help="PLINK .bed/.bim/.fam prefix")
    d.add_argument("--bfile-list", help="file listing PLINK prefixes")
    d.add_argument("--bgen", help="BGEN genotype file")
    d.add_argument("--grm", help="GRM prefix (.grm.dat/ids/snps)")
    d.add_argument("--grm-list", help="file listing GRM prefixes")
    d.add_argument("--pheno", help="phenotype file (FID IID pheno...)")
    d.add_argument("--phenos", nargs="+",
                   help="per-trait phenotype files (options.cpp:443-446)")
    d.add_argument("--pheno-col", type=_ranged(int, 1), default=1,
                   help="phenotype column (1-based)")
    d.add_argument("--pheno-cols", help="comma-separated phenotype columns "
                   "(bivar/multi/mp analyses)")
    d.add_argument("--all-phenos", action="store_true",
                   help="analyze every phenotype column in turn "
                   "(options.cpp:1081-1084)")
    d.add_argument("--covar", help="discrete covariates file")
    d.add_argument("--qcovar", help="quantitative covariates file")
    d.add_argument("--covars", help="per-trait discrete covariate files, comma-separated")
    d.add_argument("--qcovars", help="per-trait quantitative covariate files, comma-separated")
    d.add_argument("--extract", help="file of SNP ids to keep")
    d.add_argument("--keep", help="file of individuals (FID IID) to keep")
    d.add_argument("--out", default="dissect_tpu_torch", help="output prefix")

    grm = p.add_argument_group("grm")
    grm.add_argument("--grm-cutoff", type=float, default=None,
                     help="prune one of each pair with relatedness above cutoff")
    grm.add_argument("--diagonalize", action="store_true",
                     help="store/use the eigendecomposed GRM")
    grm.add_argument("--grm-flat-norm", action="store_true",
                     help="normalize by total SNP count, not per-pair counts")
    grm.add_argument("--grm-epi", action="store_true", help="epistatic GRM (K.*K)")
    grm.add_argument("--min-overlap-snps", type=float, default=0.1)
    grm.add_argument("--keep-zerostd-snps", action="store_true",
                      help="silently drop monomorphic SNPs instead of erroring")
    grm.add_argument("--gcta-grms-gz", help="GCTA .grm.id/.grm.gz prefix")
    grm.add_argument("--grm-join-method", type=_ranged(int, 0, 1), default=0,
                     help="multi-file GRM build order (auxiliar.cpp:617: "
                     "0 = per-file GRMs then add, 1 = concat genotypes then "
                     "one GRM); both orders give identical normalized GRMs "
                     "here, so the flag is accepted for compatibility")
    grm.add_argument("--min-prop-grm-inds-kept", type=_ranged(float, 0.0, 1.0),
                     default=0.9,
                     help="reject a GRM when sanitization keeps less than "
                     "this proportion of individuals (options.cpp:544-547, "
                     "kernel.cpp:2019; default options.cpp:81)")
    grm.add_argument("--store-both", action="store_true",
                     help="with --diagonalize, also write the undecomposed "
                     "GRM (options.cpp:511-515)")
    grm.add_argument("--bfile-grm-list", help="file listing PLINK prefixes, "
                     "one GRM kernel computed per entry (options.cpp:818-821)")
    grm.add_argument("--bgen-grm-list", help="file listing BGEN files, one "
                     "GRM kernel computed per entry (options.cpp:822-826)")
    grm.add_argument("--cutoff-thrs", nargs="+", type=float, default=None,
                     help="relatedness cutoffs to report prune counts for "
                     "during --make-grm-mr (pruneThresholdsCheck, "
                     "options.cpp:529-532, analysis.cpp:123-131)")
    grm.add_argument("--grm-no-mpi-write", action="store_true",
                     help="accepted for compatibility; IO is host-driven here")
    grm.add_argument("--bgen-l1", action="store_true",
                     help="accepted for compatibility; the BGEN layout is "
                     "auto-detected from the header")

    reml = p.add_argument_group("reml")
    reml.add_argument("--reml-maxit", type=int, default=40)
    reml.add_argument("--variance-threshold", type=_ranged(float, 0.0, 0.1),
                      default=1e-5)
    reml.add_argument("--gradient-threshold", type=_ranged(float, 0.0), default=1e-2)
    reml.add_argument("--ai-switch-threshold", type=_ranged(float, 0.0, 1.0),
                      default=1e-3)
    reml.add_argument("--ai-em-switch", action="store_true")
    reml.add_argument("--no-first-em", action="store_true")
    reml.add_argument("--reml-qstep-scale", type=_ranged(float, 0.0, 1.0), default=0.3)
    reml.add_argument("--initial-h2", type=_ranged(float, 0.0, 1.0), default=0.5)
    reml.add_argument("--initial-h2s", nargs="+",
                      type=_ranged(float, 0.0, 1.0), default=None,
                      help="per-trait initial h2 values (options.cpp:617-620; "
                      "incompatible with --initial-h2)")
    reml.add_argument("--use-log-logistic", action="store_true")
    reml.add_argument("--use-correlations", action="store_true")
    reml.add_argument("--use-ml", action="store_true")
    reml.add_argument("--max-correlation", type=_ranged(float, 0.0), default=1.0)
    reml.add_argument("--variance-constrain", type=float, default=1e-6)
    reml.add_argument("--gcta-mode", action="store_true")
    reml.add_argument("--no-environment-cov", action="store_true")
    reml.add_argument("--blue", action="store_true", help="write BLUE fixed effects")
    reml.add_argument("--indiv-blup", action="store_true", help="write individual BLUPs")
    reml.add_argument("--snp-blup", action="store_true", help="write per-SNP BLUP effects")
    reml.add_argument("--reml-method-em", action="store_true")
    reml.add_argument("--reml-method-ai", action="store_true",
                      help="AI-REML (the default; accepted for compatibility)")
    reml.add_argument("--reml-subsample", action="store_true",
                      help="seed initial variances from subsample pre-fits "
                      "(options.cpp:603-606; see --subsample-replicates)")
    reml.add_argument("--weights", help="kernel weights file")
    reml.add_argument("--weights-col", type=_ranged(int, 1), default=1,
                      help="column of --weights to use (options.cpp:775-778)")
    reml.add_argument("--no-scale-weights", action="store_true",
                      help="use raw environmental weights without rescaling")
    reml.add_argument("--indiv-blup-error", action="store_true",
                      help="also write BLUP standard errors "
                      "(options.cpp:561-565)")
    reml.add_argument("--write-blue-reduced", action="store_true",
                      help="write BLUEs for each reduced model too "
                      "(options.cpp:725-729)")
    reml.add_argument("--reduced-with-only", nargs="+", default=None,
                      help="only test reduced models dropping these named "
                      "covariances (options.cpp:792-795)")
    reml.add_argument("--blup-bfile-list", help="file listing PLINK prefixes "
                      "providing genotypes for --snp-blup "
                      "(options.cpp:736-740)")
    reml.add_argument("--blup-no-filter-snps", action="store_true",
                      help="keep BLUP SNPs that do not overlap the GRM SNP "
                      "set (options.cpp:742-746)")
    reml.add_argument("--force-use-diag-kernels", action="store_true",
                      help="require diagonalized kernels (errors when a "
                      "kernel cannot be diagonalized)")
    reml.add_argument("--epistasis-var", action="store_true",
                      help="add an epistatic (K.*K) variance component "
                      "alongside the GRM")
    reml.add_argument("--random-effects", help="FID IID category file adding a "
                      "discrete random-effect kernel (--random-effects)")
    reml.add_argument("--random-effects-cols", type=int, default=1)
    reml.add_argument("--multirandom-effects", help="FID IID categories file "
                      "adding a multi-category random-effect kernel")
    reml.add_argument("--multirandom-effects-cols", type=_ranged(int, 1),
                      default=1, help="number of category columns in "
                      "--multirandom-effects")
    reml.add_argument("--sqrt-exp-coord-files", help="coordinate file adding a "
                      "squared-exponential kernel")
    reml.add_argument("--gxe", action="store_true",
                      help="add a GRM x environment interaction kernel "
                      "(requires --random-effects)")
    reml.add_argument("--initial-variances", help="seed variances from a prior "
                      "fit's 'name value' file")
    reml.add_argument("--checkpoint", help="REML checkpoint file for "
                      "preemption-safe resume")
    reml.add_argument("--subsample-replicates", type=int, default=0,
                      help="pre-fit on random subsamples to seed initial "
                      "variances (options.h:124-127)")
    reml.add_argument("--subsample-proportion", type=float, default=0.2)
    reml.add_argument("--fix-correlation", type=float, default=None,
                      help="refit with the genetic correlation fixed and LRT")
    reml.add_argument("--param-init-fac", type=float, default=1.0,
                      help="initial-alpha factor for squared-exponential "
                      "kernels (expKernelParameterInitialFactor)")
    reml.add_argument("--steps-to-unfix", type=int, default=8,
                      help="Newton steps before kernel parameters unfix "
                      "(remlStepsToUnfixExpKernelParameter)")
    reml.add_argument("--no-single-precision", action="store_true",
                      help="accepted for compatibility; the engine already "
                      "finishes fits with float64 refinement")
    reml.add_argument("--skip-test-reduced-models", action="store_true")
    reml.add_argument("--indirect-effects-couples",
                      help="4-column couples file (FID1 IID1 FID2 IID2) adding "
                      "partner-resorted GRMs for indirect genetic effects")

    gwas = p.add_argument_group("gwas")
    gwas.add_argument("--igwas-covar", help="discrete covariates tested by inverse GWAS")
    gwas.add_argument("--igwas-qcovar", help="quantitative covariates tested by inverse GWAS")
    gwas.add_argument("--groups", help="SNP group file: regional REML with "
                      "--reml, grouped GWAS with --gwas")
    gwas.add_argument("--region-size", type=int, default=None,
                      help="region size in kb; triggers regional analysis "
                      "(options.cpp:979-984)")
    gwas.add_argument("--region-overlap", type=int, default=0,
                      help="region overlap in kb (options.cpp:987-992)")
    gwas.add_argument("--min-snps-region", type=int, default=1)
    gwas.add_argument("--rgwas-group-size", type=int, default=100)
    gwas.add_argument("--rgwas-maxit", type=_ranged(int, 1), default=10,
                      help="recursive-GWAS iteration cap (options.cpp:807-810)")
    gwas.add_argument("--rgwas-thresholds", nargs="+",
                      type=_ranged(float, 0.0, 1.0), default=None,
                      help="per-iteration significance thresholds for keeping "
                      "SNPs (options.cpp:803-806)")
    gwas.add_argument("--rgwas-ratio", type=_ranged(float, 1e-7, 0.1),
                      default=None,
                      help="maximum fitted-SNPs/individuals ratio per "
                      "recursive iteration (options.cpp:799-802)")
    gwas.add_argument("--parallel-gwas", action="store_true",
                      help="shard the SNP axis of the per-SNP tests over the "
                      "device mesh regardless of --distributed-threshold "
                      "(the grouped-communicator parallel GWAS, "
                      "gwas.cpp:557-687); per-SNP tests are always batched "
                      "on the accelerator even without it")
    gwas.add_argument("--nonparallel-gwas", action="store_true",
                      help="accepted for compatibility (see --parallel-gwas)")
    gwas.add_argument("--group-all", action="store_true",
                      help="grouped GWAS with one group of all SNPs")
    gwas.add_argument("--group-effects", action="store_true",
                      help="save per-individual group effects (LabeledMatrix)")
    gwas.add_argument("--snp-corr-threshold", type=float, default=0.99)
    gwas.add_argument("--gwas-use-null-variances", action="store_true",
                      help="fast path: fix variances at the null model fit "
                      "(EMMAX-style) instead of per-SNP ML refits")
    gwas.add_argument("--no-gwas-retry-unfitted", dest="gwas_retry_unfitted",
                      action="store_false", default=True,
                      help="skip the warm-started retry pass for SNPs whose "
                      "ML refit did not converge (the batched analog of the "
                      "reference's averaged sequential warm starts, "
                      "gwas.cpp:836-869)")
    gwas.add_argument("--significance-threshold", type=float, default=5e-8)
    gwas.add_argument("--group-var", action="store_true",
                      help="estimate per-group effect variances "
                      "(options.cpp:853-857)")
    gwas.add_argument("--correct-ld", action="store_true",
                      help="LD-correct grouped effect estimates")
    gwas.add_argument("--all-together", action="store_true",
                      help="fit all regions jointly instead of one model per "
                      "region (options.cpp:1014-1017)")
    gwas.add_argument("--redist-meth2", action="store_true",
                      help="accepted for compatibility; SNP distribution is "
                      "batch-driven here (options.h:192)")
    gwas.add_argument("--mostr-lower-thr", type=float, default=-1.0,
                      help="lower relatedness bound for --make-grm-mr "
                      "(mostRelatedLowerThreshold, options.cpp:84,521-523)")
    gwas.add_argument("--mostr-upper-thr", type=float, default=0.025,
                      help="upper relatedness bound for --make-grm-mr "
                      "(mostRelatedUpperThreshold, options.cpp:85,525-527)")

    eff = p.add_argument_group("group effects")
    eff.add_argument("--effects-files", nargs="+",
                     help="per-chromosome group-effect LabeledMatrix "
                     "prefixes (options.cpp:1048-1050)")
    eff.add_argument("--effects-pair-files", nargs="+",
                     help="pairs of effect prefixes for crossed correlations "
                     "(options.cpp:1062+; even count)")
    eff.add_argument("--groups-positions", help="GROUP CHR MINPOS MAXPOS "
                     "table for distance-aware filtering "
                     "(options.cpp:1044-1047)")
    eff.add_argument("--keep-groups", help="file of group labels to keep "
                     "(options.cpp:1040-1043)")
    eff.add_argument("--group-min-distance", type=_ranged(int, 0),
                     default=500000,
                     help="discard one of each correlated group pair closer "
                     "than this (options.cpp:1058-1061; default "
                     "groupDistanceForDiscarding options.cpp:234)")

    pred = p.add_argument_group("covariate prediction")
    pred.add_argument("--covar-effects", help="discrete covariate effects "
                      "file, e.g. a .blue.discrete output "
                      "(options.cpp:960-963)")
    pred.add_argument("--qcovar-effects", help="quantitative covariate "
                      "effects file (options.cpp:965-968)")
    pred.add_argument("--force-use-unestimated-values", action="store_true",
                      help="keep individuals whose covariate categories have "
                      "no stored effect (contribute 0) instead of dropping "
                      "them (options.cpp:969+)")

    pca = p.add_argument_group("pca")
    pca.add_argument("--num-eval", type=_ranged(int, 1), default=20)

    sim = p.add_argument_group("simulate/predict")
    sim.add_argument("--effect-sizes", help="causal SNP effects file")
    sim.add_argument("--simu-h2", type=_ranged(float, 0.0, 1.0), default=0.5)
    sim.add_argument("--simu-binary", action="store_true")
    sim.add_argument("--simu-quantitative", action="store_true")
    sim.add_argument("--prevalence", type=_ranged(float, 0.0, 1.0), default=0.1)
    sim.add_argument("--snp-effects", help="SNP effect file for prediction")
    sim.add_argument("--random-seed", type=int, default=1)

    lm = p.add_argument_group("labeled-matrix")
    lm.add_argument("--imatrix", help="input labeled-matrix prefix for --filter-matrix")
    lm.add_argument("--row-labels", help="file of row labels to keep")
    lm.add_argument("--col-labels", help="file of column labels to keep")

    misc = p.add_argument_group("misc")
    misc.add_argument("--mesh", default="auto",
                      help="device mesh: 'auto' (all devices, near-square "
                      "grid — the nProcRows x nProcCols factoring, "
                      "communicator.cpp:66-79), 'none', 'RxC', or a device "
                      "count")
    misc.add_argument("--distributed-threshold", type=_ranged(int, 0),
                      default=16384,
                      help="minimum cohort size for the sharded multi-chip "
                      "engines (below it one chip is faster)")
    misc.add_argument("--force-distributed", action="store_true",
                      help="run the sharded engines regardless of size")
    misc.add_argument("--verbose", action="store_true")
    misc.add_argument("--zout", action="store_true", help="gzip result files")
    misc.add_argument("--default-block-size", type=int, default=None,
                      help="Cholesky panel width for the distributed "
                      "engines (the BLACS_BLOCKSIZE analog, "
                      "communicator.cpp:82-96; auto-picked when unset)")
    misc.add_argument("--check", action="store_true",
                      help="parse and echo options, run no analysis")
    misc.add_argument("--debug", action="store_true",
                      help="accepted for compatibility (reference debug mode)")
    misc.add_argument("--debug-vars", action="store_true",
                      help="accepted for compatibility")
    misc.add_argument("--mpi-debug", action="store_true",
                      help="accepted for compatibility; no MPI here "
                      "(communicator.cpp:630-641)")
    misc.add_argument("--debug-default-block-size", type=int, default=None,
                      help="accepted for compatibility")

    mp = p.add_argument_group("multi-phenotype")
    mp.add_argument("--bfile-residuals-list", help="file pairing PLINK "
                    "prefixes with residual matrices for chunked mpgwas")
    mp.add_argument("--bgen-residuals-list", help="file pairing BGEN files "
                    "with residual matrices for chunked mpgwas")
    mp.add_argument("--adjust-bfile-list", help="file listing PLINK prefixes "
                    "whose SNPs adjust the residuals before mpgwas")
    return p


@dataclasses.dataclass
class Options:
    """Parsed options + derived analysis selection."""

    args: argparse.Namespace
    analysis: Optional[str]

    @staticmethod
    def parse(argv: Optional[List[str]] = None) -> "Options":
        parser = build_parser()
        args = parser.parse_args(argv)
        argv_list = list(argv) if argv is not None else sys.argv[1:]
        if "--initial-h2" in argv_list and "--initial-h2s" in argv_list:
            raise OptionsError(
                "--initial-h2 and --initial-h2s cannot be used at the same "
                "time (options.cpp:1237-1240)"
            )
        if args.pheno and args.phenos:
            raise OptionsError(
                "--pheno and --phenos cannot be used at the same time "
                "(options.cpp:1245-1248)"
            )
        if (args.region_size or args.region_overlap) and args.groups:
            raise OptionsError(
                "only one type of regional analysis is allowed: "
                "--region-size/--region-overlap or --groups "
                "(options.cpp:1582-1585)"
            )
        selected = list(
            dict.fromkeys(dest for _, dest, _ in ANALYSES if getattr(args, dest))
        )
        if len(selected) > 1:
            raise OptionsError(
                f"incompatible analyses selected together: {selected} "
                "(options.cpp:1229-1664 incompatibility checks)"
            )
        return Options(args=args, analysis=selected[0] if selected else None)

    def reml_options(self) -> REMLOptions:
        a = self.args
        return REMLOptions(
            max_iterations=a.reml_maxit,
            variance_convergence_threshold=a.variance_threshold,
            gradient_convergence_threshold=a.gradient_threshold,
            change_ai_step_threshold=a.ai_switch_threshold,
            allow_switch_from_ai_to_em=a.ai_em_switch,
            first_step_em=not a.no_first_em,
            step_weighting_constant=a.reml_qstep_scale,
            maximum_correlation_covariance_constrain=a.max_correlation,
            use_log_logistic_scale=a.use_log_logistic,
            variance_constrain_proportion=a.variance_constrain,
            reml_method_em=a.reml_method_em,
            gcta_mode=a.gcta_mode,
            use_ml=a.use_ml,
            initial_h2=a.initial_h2,
            exp_kernel_initial_factor=a.param_init_fac,
            parameter_unfix_after=a.steps_to_unfix,
        )

    def echo(self, log):
        """Echo parsed options to the log (options.h:309-310)."""
        log.message("Options:")
        for key, val in sorted(vars(self.args).items()):
            if val not in (None, False):
                log.message(f"  --{key.replace('_', '-')} {val if val is not True else ''}")
