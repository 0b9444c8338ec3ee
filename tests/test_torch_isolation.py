"""The port stands alone: no module of dissect_tpu_torch, nor
chip_smoke.py, loads JAX or anything of the JAX package, and the CLI
never falls back to the CPU on its own.  The import checks run in a
fresh interpreter, since this test process has JAX loaded already; a
static scan of every import statement, nested ones included, catches
what importing a module does not run (imports inside functions)."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "dissect_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dissect_tpu")


def forbidden_imports(source: str, filename: str = "<source>"):
    """(line, module) of every import statement in `source`, at any
    depth, that names jax, jaxlib or dissect_tpu (not dissect_tpu_torch)."""
    found = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                found.append((node.lineno, name))
    return found


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_statement_names_jax(path):
    assert forbidden_imports((REPO / path).read_text(), path) == []


def test_import_scan_sees_nested_imports():
    source = textwrap.dedent(
        """
        import dissect_tpu_torch.io.bgen
        from dissect_tpu_torch import convert
        def phase():
            from dissect_tpu.io import bgen
            if True:
                import jax.numpy as jnp, numpy
            class C:
                def f(self):
                    import jaxlib
                    from jax import lax
        """
    )
    assert [name for _, name in forbidden_imports(source)] == [
        "dissect_tpu.io", "jax.numpy", "jaxlib", "jax"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "DISSECT_TPU_TORCH_DEVICE"}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_port_modules_load_no_jax():
    code = textwrap.dedent(
        """
        import importlib, importlib.util, pkgutil, sys
        import dissect_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(dissect_tpu_torch.__path__, "dissect_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(k for k in sys.modules
                     if k == "jax" or k.startswith("jax.") or k == "jaxlib"
                     or k == "dissect_tpu" or k.startswith("dissect_tpu."))
        assert not bad, bad
        assert len(names) > 20, names
        print("imported", len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "imported" in out.stdout


def _cli(tmp_path, **env):
    argv = [sys.executable, "-m", "dissect_tpu_torch", "--make-grm",
            "--bfile", str(REPO / "tests" / "golden" / "cohort"), "--out", str(tmp_path / "o")]
    return subprocess.run(argv, capture_output=True, text=True, env=_env(**env),
                          cwd=tmp_path, timeout=300)


def test_cli_without_a_card_exits_1(tmp_path):
    """No CUDA device visible and no CPU asked for: exit 1 with a message,
    and no output files.  CUDA_VISIBLE_DEVICES='' hides any card, so the
    check holds on machines that have one too."""
    out = _cli(tmp_path, CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 1, out.stdout + out.stderr
    assert "DISSECT_TPU_TORCH_DEVICE=cpu" in out.stderr
    assert not (tmp_path / "o.grm.dat").exists()
    asked = _cli(tmp_path, CUDA_VISIBLE_DEVICES="", DISSECT_TPU_TORCH_DEVICE="cuda")
    assert asked.returncode == 1
    assert "no CUDA device" in asked.stderr


def test_cli_on_the_cpu_when_asked(tmp_path):
    out = _cli(tmp_path, DISSECT_TPU_TORCH_DEVICE="cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert (tmp_path / "o.grm.dat").exists()
    assert "Device: cpu" in out.stdout
