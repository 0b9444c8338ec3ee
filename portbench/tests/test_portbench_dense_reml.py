"""The plain dense REML (tiles, a blocked Cholesky and tr(V^-1) from the
factor's inverse) against the plain fit in the GRM's eigenbasis, at
N = 300 with tiles smaller than N, on the CPU; and the mesh cell's
check, which refits from the program's variances, reads a variance
altered by 1e-4 as not correct."""

import json
from pathlib import Path

import pytest
import torch

from portbench import run as harness
from portbench.cohort import make_cohort
from portbench.reference import dense_reml as D
from portbench.reference import grm as R
from portbench.reference import mixed_model as MM
from portbench.reference.genotypes import cohort_blocks

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "ukb_array_n60k.json"
N, TILE = 300, 64
CLOSE = 1e-10


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    cfg = json.loads(CONFIG.read_text())
    cfg.update(n_individuals=N, n_snps=1500, n_causal=40)
    return make_cohort(cfg, 2**31 + 7, tmp_path_factory.mktemp("dense"), "cpu", n_traits=2)


@pytest.fixture(scope="module")
def kern(cohort):
    return D.grm(cohort_blocks(cohort, "cpu"), cohort.n, True, "cpu", tile=TILE)


@pytest.fixture(scope="module")
def eigen_fits(cohort, kern):
    lam, u = torch.linalg.eigh(kern)
    x_rot = u.T @ torch.as_tensor(cohort.design())
    fits = []
    for y in cohort.traits:
        fit = MM.reml_diagonal(lam, u.T @ torch.as_tensor(y), x_rot)
        fit["blup"] = fit["theta"][0] * (u @ (lam * fit["py"]))
        fits.append(fit)
    return fits


def test_the_tiled_grm_is_the_plain_grm(cohort, kern):
    plain, _ = R.grm(cohort_blocks(cohort, "cpu"), cohort.n, True, "cpu")
    assert torch.equal(kern, kern.T)
    assert (kern - plain).abs().max() <= 1e-13


def test_the_blocked_factor_and_inverse_trace(kern):
    v = 0.6 * kern + 0.5 * torch.eye(N, dtype=torch.float64)
    bounds = D.tiles(N, TILE)
    f = v.clone()
    D.factor(f, bounds)
    assert (f.tril() - torch.linalg.cholesky(v)).abs().max() <= CLOSE
    assert abs(float(D.inverse_trace(f, bounds)) / float(torch.linalg.inv(v).trace()) - 1) <= CLOSE


@pytest.mark.parametrize("start", ["default", "near"])
@pytest.mark.parametrize("trait", [0, 1])
def test_the_dense_fit_is_the_eigenbasis_fit(cohort, kern, eigen_fits, trait, start):
    ref = eigen_fits[trait]
    theta0 = None if start == "default" else ref["theta"] * (1 + 1e-4)
    fit = D.reml_dense(kern, torch.empty_like(kern), cohort.traits[trait], cohort.design(),
                       start=theta0, tile=TILE)
    assert fit["steps"] < D.MAX_STEPS
    assert (fit["theta"] / ref["theta"] - 1).abs().max() <= CLOSE
    assert abs(float(fit["logl"] - ref["logl"])) <= CLOSE * abs(float(ref["logl"]))
    assert ((fit["blue"] - ref["blue"]).abs() / ref["blue_se"]).max() <= CLOSE
    assert (fit["blue_se"] / ref["blue_se"] - 1).abs().max() <= CLOSE
    assert (fit["blup"] - ref["blup"]).abs().max() <= CLOSE * ref["blup"].abs().max()


def test_a_variance_altered_by_1e_4_is_not_correct(cohort, eigen_fits, tmp_path):
    """The check of the mesh cell, given units whose variances are the
    optimum's altered by 1e-4 (and, as a control of the test, unaltered)."""
    unit_kind = harness.load_module(harness.BENCH_DIR / "units" / "reml_mesh.py", "reml_mesh_t")
    limits = json.loads((harness.BENCH_DIR / "limits" / "array_reml_mesh4.json").read_text())
    ctx = harness.Context(seed=7, device=torch.device("cpu"), workdir=tmp_path, cohort=cohort)
    outputs = []
    for t, ref in enumerate(eigen_fits):
        outputs.append({"trait": t, "success": True, "theta": ref["theta"].numpy(),
                        "logl": float(ref["logl"]), "iterations": 5,
                        "blue": ref["blue"].numpy(), "blue_se": ref["blue_se"].numpy(),
                        "blup": ref["blup"].numpy()})
    compared, failed = harness.check(unit_kind, ctx, outputs, limits)
    assert failed == 0 and all(v <= lim for v, lim in compared.values()), compared
    for out in outputs:
        out["theta"] = out["theta"] * (1 + 1e-4)
    compared, failed = harness.check(unit_kind, ctx, outputs, limits)
    assert failed == len(outputs)
    assert compared["variance_gap"][0] == pytest.approx(1e-4, rel=1e-3)
    assert not compared["variance_gap"][0] <= compared["variance_gap"][1]
