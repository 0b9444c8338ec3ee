"""Regional heritability REML.

Parity: SingleREML::computeRegional (singlereml.cpp:230-360): for every
SNP region fit a 2-kernel model — the "Regional-GRM" built from the
region's SNPs and the "Global-GRM" = full GRM minus regional (via the
denormalize/add/renormalize kernel algebra, kernel.cpp:1705) — with
initial-weight split proportional to the region's SNP share
(singlereml.cpp:322-328), testing both kernels via reduced-model LRTs.
SingleREML::computeMultipleGroups fits all regional GRMs jointly
instead.  Port of dissect_tpu/reml/regional.py: every GRM is built on
`device` (kernel K1 for PLINK data on the card) and every fit runs there
in float64.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from dissect_tpu_torch.io.covariate import Covariate
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.model.kernels import Kernel, grm_from_plink
from dissect_tpu_torch.reml.engine import REMLOptions
from dissect_tpu_torch.reml.multi import MultiREML
from dissect_tpu_torch.reml.single import SingleREML
from dissect_tpu_torch.runtime.log import get_logger
from dissect_tpu_torch.runtime.timers import timers


def _regional_pair(data, grm: Kernel, snps: List[str], device):
    """(Global-GRM, Regional-GRM, the region's SNP share)."""
    regional = grm_from_plink(data.filter(keep_snps=snps), name="Regional-GRM", device=device)
    global_ = grm.add(regional, subtract=True)
    global_.name = "Global-GRM"
    return global_, regional, len(snps) / data.n_snps


def compute_regional(
    data,
    grouping: Dict[str, List[str]],
    phenotype: Phenotype,
    covariate: Optional[Covariate] = None,
    options: Optional[REMLOptions] = None,
    grm: Optional[Kernel] = None,
    test_global: bool = True,
    device="cuda",
) -> Dict[str, dict]:
    """Per-region 2-kernel REML with LRTs.  Returns region -> results."""
    options = options or REMLOptions()
    log = get_logger()
    if grm is None:
        grm = grm_from_plink(data, device=device)
    results: Dict[str, dict] = {}
    for group, snps in grouping.items():
        log.message(f"\nAnalysing region {group}...")
        with timers.phase("ComputeGRM"):
            global_, regional, proportion = _regional_pair(data, grm, snps, device)
        sreml = SingleREML([global_, regional], phenotype, covariate, options, device=device)
        to_test = ["Regional-GRM"] + (["Global-GRM"] if test_global else [])
        full, lrts = sreml.compute_with_reduced_models(
            elements_to_test=to_test, weights=[1.0 - proportion, proportion]
        )
        results[group] = {
            "full": full,
            "lrts": lrts,
            "n_snps": len(snps),
            "proportion": proportion,
        }
    return results


def compute_regional_multi(
    data,
    grouping: Dict[str, List[str]],
    phenotypes,
    covariates=None,
    options: Optional[REMLOptions] = None,
    grm: Optional[Kernel] = None,
    use_correlations: bool = False,
    device="cuda",
):
    """Multi-trait regional REML (MultiREML::computeRegional,
    multireml.cpp:139+): per region, the Global/Regional kernel pair is
    fitted jointly across traits with cross-trait covariances."""
    options = options or REMLOptions()
    log = get_logger()
    if grm is None:
        grm = grm_from_plink(data, device=device)
    results: Dict[str, dict] = {}
    for group, snps in grouping.items():
        log.message(f"\nAnalysing region {group} (multi-trait)...")
        global_, regional, proportion = _regional_pair(data, grm, snps, device)
        sreml = MultiREML(
            [global_, regional], phenotypes, covariates, options,
            use_correlations=use_correlations, device=device,
        )
        out = sreml.compute(weights=[1.0 - proportion, proportion])
        results[group] = {"full": out, "n_snps": len(snps), "proportion": proportion}
    return results


def compute_multiple_groups(
    data,
    grouping: Dict[str, List[str]],
    phenotype: Phenotype,
    covariate: Optional[Covariate] = None,
    options: Optional[REMLOptions] = None,
    device="cuda",
):
    """All regional GRMs fitted jointly (SingleREML::computeMultipleGroups)."""
    options = options or REMLOptions()
    kernels = [
        grm_from_plink(data.filter(keep_snps=snps), name=f"GRM-{group}", device=device)
        for group, snps in grouping.items()
    ]
    sreml = SingleREML(kernels, phenotype, covariate, options, device=device)
    return sreml.compute_with_reduced_models(elements_to_test=[k.name for k in kernels])
