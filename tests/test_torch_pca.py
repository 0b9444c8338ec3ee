"""The port's `--pca` held against the JAX package on the CPU.

`eigh_topk` draws its random start from a torch.Generator, JAX from
jax.random, so the two are held on converged eigenpairs of a planted,
well-gapped spectrum, eigenvectors up to sign.  golden.pca.* took the
full-eigh branch (--num-eval 5 on 24 individuals: 5 * 8 >= 24) in
float32: its eigenvalues are held exactly against np.linalg.eigvalsh at
rtol 1e-6 (tests/test_golden.py:381-390) and against the golden file
within twice the float32 solver bound, as tests/test_torch_cli.py holds
golden.diag.grm.diag."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.linalg.eigen import eigh_topk as jax_eigh_topk
from dissect_tpu.model.kernels import Kernel as JaxKernel
from dissect_tpu.model.kernels import KernelType as JaxKernelType
from dissect_tpu.pca.pca import PCA as JaxPCA
from dissect_tpu.pca.pca import compute_pca as jax_compute_pca
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.io.grm_io import read_grm
from dissect_tpu_torch.linalg.eigen import eigh_topk
from dissect_tpu_torch.model.kernels import Kernel, KernelType
from dissect_tpu_torch.pca.pca import PCA, compute_pca
from tests.conftest import make_plink

GOLDEN = pathlib.Path(__file__).parent / "golden"
EPS32 = float(np.finfo(np.float32).eps)


def _planted(n=60, k=5, seed=3):
    """A symmetric matrix with top eigenvalues 10, 9, ..., well above a
    bulk in [0, 0.1]."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = np.concatenate([10.0 - np.arange(k), rng.uniform(0.0, 0.1, n - k)])
    return (q * w) @ q.T, np.sort(w)[::-1], q[:, :k]


def _keys(n):
    return [f"F{i}@I{i}" for i in range(n)]


def _assert_vectors(ours, theirs, atol):
    """Columns equal up to sign."""
    signs = np.sign(np.sum(ours * theirs, axis=0))
    np.testing.assert_allclose(ours * signs, theirs, rtol=0, atol=atol)


@pytest.mark.parametrize("n_iter", [12, 30])
def test_eigh_topk_converges_like_jax(n_iter):
    a, w, v = _planted()
    w_t, v_t = eigh_topk(torch.as_tensor(a), k=5, n_iter=n_iter, seed=1)
    w_j, v_j = jax_eigh_topk(jnp.asarray(a), k=5, n_iter=n_iter, seed=1)
    assert w_t.dtype == torch.float64 and tuple(v_t.shape) == (60, 5)
    np.testing.assert_allclose(w_t.numpy(), w[:5], rtol=1e-10)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-10)
    _assert_vectors(v_t.numpy(), v, atol=1e-9)
    _assert_vectors(v_t.numpy(), np.asarray(v_j), atol=1e-9)


def test_eigh_topk_start_is_seeded():
    a, _, _ = _planted()
    first = eigh_topk(torch.as_tensor(a), k=3, n_iter=0, seed=7)[0]
    again = eigh_topk(torch.as_tensor(a), k=3, n_iter=0, seed=7)[0]
    other = eigh_topk(torch.as_tensor(a), k=3, n_iter=0, seed=8)[0]
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    assert not torch.equal(first, other)


def _kernels(a, diagonalized=False):
    n = a.shape[0]
    ours = Kernel(name="GRM", type=KernelType.GRM, individual_keys=_keys(n),
                  matrix=torch.as_tensor(a))
    theirs = JaxKernel(name="GRM", type=JaxKernelType.GRM, individual_keys=_keys(n),
                       matrix=jnp.asarray(a))
    if diagonalized:
        return ours.diagonalize(), theirs.diagonalize()
    return ours, theirs


@pytest.mark.parametrize("branch,k", [("randomized", 5), ("full", 12), ("diagonalized", 5)])
def test_compute_pca_matches_jax(branch, k):
    """The three branches: randomized (k * 8 < n), the full spectrum, and
    a kernel that is diagonalized already."""
    a, _, _ = _planted()
    ours_k, theirs_k = _kernels(a, diagonalized=branch == "diagonalized")
    ours, theirs = compute_pca(ours_k, k), jax_compute_pca(theirs_k, k)
    assert (ours.all_eigenvalues is None) == (branch == "randomized")
    assert (theirs.all_eigenvalues is None) == (branch == "randomized")
    np.testing.assert_allclose(ours.eigenvalues, np.asarray(theirs.eigenvalues),
                               rtol=1e-10, atol=1e-12)
    if ours.all_eigenvalues is not None:
        np.testing.assert_allclose(ours.all_eigenvalues, np.asarray(theirs.all_eigenvalues),
                                   rtol=1e-9, atol=1e-12)
    # the bulk eigenvalues are close together: vectors beyond the planted
    # five are held only on the randomized branch's k
    _assert_vectors(ours.eigenvectors[:, :5], np.asarray(theirs.eigenvectors)[:, :5], 1e-9)


def test_pca_write_formats_like_jax(tmp_path):
    rng = np.random.default_rng(5)
    vals, vecs, spectrum = rng.normal(size=3), rng.normal(size=(4, 3)), rng.normal(size=4)
    for all_eigenvalues in (None, spectrum):
        PCA(_keys(4), vals, vecs, all_eigenvalues).write(str(tmp_path / "t"))
        JaxPCA(_keys(4), vals, vecs, all_eigenvalues).write(str(tmp_path / "j"))
        for ext in ("pca.eigenvalues", "pca.eigenvectors"):
            assert (tmp_path / f"t.{ext}").read_text() == (tmp_path / f"j.{ext}").read_text()


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")


def _read_vectors(path):
    return np.array([[float(v) for v in ln.split()[2:]] for ln in path.read_text().splitlines()])


@pytest.fixture
def golden_pca(tmp_path, cpu):
    main(["--pca", "--grm", str(GOLDEN / "golden"), "--num-eval", "5", "--bfile",
          str(GOLDEN / "cohort"), "--pheno", str(GOLDEN / "pheno.txt"), "--mesh", "none",
          "--out", str(tmp_path / "golden")])
    return tmp_path


def test_golden_pca_is_the_exact_spectrum(golden_pca):
    k = read_grm(str(GOLDEN / "golden"))["kernel"]
    w, v = np.linalg.eigh(k)
    ours = np.loadtxt(golden_pca / "golden.pca.eigenvalues")
    np.testing.assert_allclose(ours, w[::-1], rtol=1e-6, atol=1e-9)
    vecs = _read_vectors(golden_pca / "golden.pca.eigenvectors")
    assert vecs.shape == (24, 5)
    _assert_vectors(vecs, v[:, ::-1][:, :5], atol=1e-7)


def test_golden_pca_matches_golden_to_float32_eigensolver_accuracy(golden_pca):
    """golden.pca.* came from a float32 eigh of the float32 GRM: its
    eigenvalues carry up to c eps32 |K| of error, its eigenvectors that
    over the eigenvalue gap; the port's float64 pairs are within twice
    those bounds."""
    old = np.loadtxt(GOLDEN / "golden.pca.eigenvalues")
    new = np.loadtxt(golden_pca / "golden.pca.eigenvalues")
    scale = np.max(np.abs(old))
    np.testing.assert_allclose(new, old, rtol=0, atol=2 * EPS32 * scale)
    gap = np.min(np.abs(np.diff(old[:6])))
    _assert_vectors(_read_vectors(golden_pca / "golden.pca.eigenvectors"),
                    _read_vectors(GOLDEN / "golden.pca.eigenvectors"),
                    atol=2 * EPS32 * scale / gap)
    ours = (golden_pca / "golden.pca.eigenvectors").read_text().split("\n")
    theirs = (GOLDEN / "golden.pca.eigenvectors").read_text().split("\n")
    assert [ln.split()[:2] for ln in ours] == [ln.split()[:2] for ln in theirs]


def test_pca_bfile_randomized_matches_jax_cli(tmp_path, cpu):
    """--pca --bfile: the GRM built in line, then the randomized branch
    (2 * 8 < 120) on a cohort of three populations, whose two leading
    eigenvalues stand well above the bulk.  The JAX CLI runs eigh_topk on
    the float32 GRM in float32; the port in float64."""
    rng = np.random.default_rng(11)
    n, m = 120, 400
    freqs = rng.uniform(0.05, 0.95, size=(3, m))
    pop = np.arange(n) % 3
    p = freqs[pop].T  # (m, n)
    dosage = ((rng.random((m, n)) < p).astype(np.int8) + (rng.random((m, n)) < p)).astype(np.int8)
    keep = (dosage.sum(1) > 0) & (dosage.sum(1) < 2 * n)
    bfile, _ = make_plink(tmp_path, dosage[keep])
    argv = ["--pca", "--bfile", bfile, "--num-eval", "2", "--mesh", "none"]
    ours = main(argv + ["--out", str(tmp_path / "t")])
    try:
        jax_main(argv + ["--out", str(tmp_path / "j")])
        jax_main(["--make-grm", "--bfile", bfile, "--mesh", "none", "--out", str(tmp_path / "g")])
    finally:
        set_mesh_context(None)
    assert ours.all_eigenvalues is None
    w, v = np.linalg.eigh(read_grm(str(tmp_path / "g"))["kernel"].astype(np.float64))
    new = np.loadtxt(tmp_path / "t.pca.eigenvalues")
    np.testing.assert_allclose(new, w[::-1][:2], rtol=1e-7)
    old = np.loadtxt(tmp_path / "j.pca.eigenvalues")
    np.testing.assert_allclose(new, old, rtol=0, atol=4 * EPS32 * w.max())
    _assert_vectors(_read_vectors(tmp_path / "t.pca.eigenvectors"), v[:, ::-1][:, :2], 1e-6)
