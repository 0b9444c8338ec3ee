"""The plain reference agrees with the program at a small size on the
CPU, where the program runs in float64 through its kernels' plain
versions.  Only these tests import the program beside the reference."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.cohort import make_cohort
from portbench.reference import genotypes as G
from portbench.reference import grm as R
from portbench.reference import mixed_model as MM

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.fixture(scope="module", params=["ukb_array_n20k", "ukb_imputed_n20k"])
def cohort(request, tmp_path_factory):
    cfg = json.loads((CONFIGS / f"{request.param}.json").read_text())
    cfg.update(n_individuals=400, n_snps=1500, n_causal=40)
    return make_cohort(cfg, 2**31 + 3, tmp_path_factory.mktemp(request.param), "cpu")


def program_data(cohort):
    from dissect_tpu_torch.io.bed import read_plink
    from dissect_tpu_torch.io.bgen import read_bgen

    path = cohort.argv[1]
    return read_plink(path, device="cpu") if cohort.kind == "plink" else read_bgen(path, device="cpu")


@pytest.fixture(scope="module")
def ref_grm(cohort):
    return R.grm(G.cohort_blocks(cohort, "cpu"), cohort.n, cohort.kind == "plink", "cpu")


def test_statistics_match_the_programs(cohort):
    stats = program_data(cohort).stats()
    mean, std = G.row_stats(G.cohort_rows(cohort, 0, cohort.m, "cpu"), cohort.kind == "plink")
    # exact for hard calls; imputed dosages are float32 in the program
    tol = 1e-12 if cohort.kind == "plink" else 1e-6
    assert np.allclose(mean.numpy(), stats.mean, rtol=0, atol=tol)
    assert np.allclose(std.numpy(), stats.std, rtol=tol, atol=0)


def test_grm_matches_the_programs(cohort, ref_grm):
    from dissect_tpu_torch.model.kernels import grm_from_plink

    kern = grm_from_plink(program_data(cohort), device="cpu")
    ref_k, ref_c = ref_grm
    # the program accumulates in float32: its rounding, at entries of about 1
    assert (kern.matrix.double() - ref_k).abs().max() <= 1e-5
    assert torch.equal(kern.counts.double(), ref_c)


def test_refit_matches_the_program_on_the_same_eigenbasis(cohort, ref_grm):
    from dissect_tpu_torch.gwas.mlm import mlm_gwas_ml_refit

    lam, u = torch.linalg.eigh(ref_grm[0])
    y, x = torch.as_tensor(cohort.traits[0]), torch.as_tensor(cohort.design())
    y_rot, x_rot = u.T @ y, u.T @ x
    theta0 = MM.reml_diagonal(lam, y_rot, x_rot)["theta"]
    rows = G.cohort_rows(cohort, 0, 300, "cpu")
    g = G.centered(rows, G.row_stats(rows, cohort.kind == "plink")[0])
    fit = MM.ml_refit(g @ u, y_rot, x_rot, lam, theta0)
    res = mlm_gwas_ml_refit(g, cohort.traits[0], cohort.design(), lam, u, theta0.numpy())
    ok = res.converged
    assert ok.mean() > 0.95
    assert np.abs(res.snp_beta[ok] - fit["beta"].numpy()[ok]).max() <= 1e-8
    assert np.abs(res.snp_se[ok] / fit["se"].numpy()[ok] - 1).max() <= 1e-8
    assert np.allclose(res.snp_p[ok], fit["p"].numpy()[ok], rtol=1e-7, atol=1e-12)


def test_null_fit_matches_the_programs(cohort, ref_grm):
    from dissect_tpu_torch.io.covariate import read_covariates
    from dissect_tpu_torch.io.phenotype import read_phenotype
    from dissect_tpu_torch.model.kernels import Kernel, KernelType
    from dissect_tpu_torch.reml.single import SingleREML

    pheno = read_phenotype(cohort.argv[3])
    covar = read_covariates(None, cohort.argv[5])
    lam, u = torch.linalg.eigh(ref_grm[0])
    keys = pheno.keys
    kern = Kernel(name="GRM", type=KernelType.GRM, individual_keys=keys, diagonalized=True,
                  eigenvalues=lam, eigenvectors=u)
    out = SingleREML([kern], pheno, covar, device="cpu").compute(compute_blue=False)
    theta = MM.reml_diagonal(lam, u.T @ torch.as_tensor(cohort.traits[0]),
                             u.T @ torch.as_tensor(cohort.design()))["theta"]
    # the program stops at relative variance changes of 1e-5
    assert np.allclose(out.result.variances, theta.numpy(), rtol=1e-4)


def test_dense_reml_matches_the_programs(cohort, ref_grm):
    """The program's dense fit (a Cholesky inverse each iteration) and
    the reference's fit in the eigenbasis meet at the optimum."""
    from dissect_tpu_torch.io.covariate import read_covariates
    from dissect_tpu_torch.io.phenotype import read_phenotype
    from dissect_tpu_torch.model.kernels import Kernel, KernelType
    from dissect_tpu_torch.reml.single import SingleREML

    pheno = read_phenotype(cohort.argv[3])
    covar = read_covariates(None, cohort.argv[5])
    kern = Kernel(name="GRM", type=KernelType.GRM, individual_keys=pheno.keys,
                  matrix=ref_grm[0].float(), counts=ref_grm[1].float())
    out = SingleREML([kern], pheno, covar, device="cpu").compute(compute_blue=True,
                                                                 compute_blup=True)
    lam, u = torch.linalg.eigh(ref_grm[0].float().double())
    ref = MM.reml_diagonal(lam, u.T @ torch.as_tensor(cohort.traits[0]),
                           u.T @ torch.as_tensor(cohort.design()))
    blup = (ref["theta"][0] * (u @ (lam * ref["py"]))).numpy()
    assert out.result.success
    assert np.allclose(out.result.variances, ref["theta"].numpy(), rtol=1e-4)
    assert abs(out.result.log_likelihood - float(ref["logl"])) <= 1e-5 * abs(float(ref["logl"]))
    se = ref["blue_se"].numpy()
    assert np.abs(out.blue - ref["blue"].numpy()).max() <= 1e-4 * se.min()
    assert np.allclose(out.blue_se, se, rtol=1e-4)
    assert np.abs(out.blup["GRM"] - blup).max() <= 1e-4 * np.abs(blup).max()
