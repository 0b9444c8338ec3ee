"""Per-SNP BLUP effects from a fitted REML model.

Parity: REML::computeSNPsBLUP (reml.cpp:3098-3356): for sub-covariance
(GRM) `name` with fitted variance s2, the SNP effects are

  blup_s = s2 * (Z_s . Py) * n_total / (n_nonmissing_s * n_grm_snps)

over the standardized genotype rows Z_s used to build the GRM, written
as `.<name>.blup.snps` with columns SNP ALLELE BLUP STDEV MEAN NBLUP
(reml.cpp:3330-3346).  These files feed polygenic prediction
(predictphenotype loadREMLEffect).

Port of dissect_tpu/reml/snp_blup.py with one departure, in memory only:
the JAX version forms the whole M x N float64 dosage matrix and its
standardized copy on the host (4 GB each at 50,000 SNPs x 10,000
individuals).  Here SNP chunks of the raw dosages are decoded on the
device (K4 for PLINK data, from a filtered view that copies nothing),
are standardized there in float64 as the GRM build standardizes them
(`linalg.syrk.standardize_chunk`), and meet Py in one float64 product
per chunk.  The numbers are the same.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from dissect_tpu_torch.io.bed import PlinkData
from dissect_tpu_torch.io.bgen import BgenData
from dissect_tpu_torch.io.ids import order_as_template
from dissect_tpu_torch.linalg.syrk import standardize_chunk
from dissect_tpu_torch.runtime.log import output_open

# SNP rows per device chunk: 8,192 x 10,000 float64 is 0.66 GB
SNP_BLUP_CHUNK = 8192


def compute_snp_blup(
    data: Union[PlinkData, BgenData],
    individual_keys: List[str],
    py,
    genetic_variance: float,
    grm_snp_names: Optional[List[str]] = None,
    chunk: int = SNP_BLUP_CHUNK,
) -> dict:
    """SNP BLUPs for a single-trait fit.

    data: the genotype fileset used for the GRM; individual_keys / py:
    the analysis individuals (GRM order) and the fitted P y vector, a
    float64 tensor whose device the chunks go to; genetic_variance: the
    sub-covariance's fitted variance.
    """
    if grm_snp_names is None:
        grm_snp_names = data.snp_names
    keep = order_as_template(data.snp_names, grm_snp_names)
    sub = data.filter(keep_snps=keep, keep_individuals=individual_keys)
    stats = sub.stats()
    py = torch.as_tensor(py, dtype=torch.float64)
    device = py.device
    mean = torch.as_tensor(stats.mean, dtype=torch.float64, device=device)
    inv_std = 1.0 / torch.as_tensor(stats.std, dtype=torch.float64, device=device)
    raw, n_nonmissing = [], []
    for start in range(0, sub.n_snps, chunk):
        stop = min(start + chunk, sub.n_snps)
        z, observed = standardize_chunk(
            sub.decode_rows(start, stop).to(device), mean[start:stop], inv_std[start:stop],
            torch.float64,
        )
        raw.append(z @ py)
        n_nonmissing.append(observed.sum(1))
    raw = torch.cat(raw).cpu().numpy()
    n_nonmissing = torch.cat(n_nonmissing).cpu().numpy()
    blup = (
        genetic_variance
        * raw
        * len(individual_keys)
        / (np.maximum(n_nonmissing, 1.0) * len(grm_snp_names))
    )
    return {
        "snp_names": sub.snp_names,
        "alleles": [s.allele2 for s in sub.snps],
        "blup": blup,
        "std": stats.std,
        "mean": stats.mean,
    }


def write_snp_blup(prefix: str, name: str, result: dict, pheno_suffix: str = ""):
    """Write .<name>.blup.snps (reml.cpp:3330-3346)."""
    fname = f"{prefix}.{name.replace(' ', '_')}{pheno_suffix}.blup.snps"
    with output_open(fname, "w") as fh:
        fh.write("SNP ALLELE BLUP STDEV MEAN NBLUP\n")
        for i, snp in enumerate(result["snp_names"]):
            blup = result["blup"][i]
            std = result["std"][i]
            fh.write(
                f"{snp} {result['alleles'][i]} {blup:.14g} {std:.14g} "
                f"{result['mean'][i]:.14g} {blup / std:.14g}\n"
            )
    return fname
