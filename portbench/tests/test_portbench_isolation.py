"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program: checked in a fresh interpreter,
by whole top-level module names (`dissect_tpu_torch` begins with
`dissect_tpu`)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LOADED = """
import importlib.util, json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
for name in {modules!r}:
    __import__(name)
for path in sorted(Path({root!r}, "portbench").glob("*/*.py")):
    if path.parent.name in ("metrics", "units"):
        spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(*modules):
    out = subprocess.run([sys.executable, "-c", LOADED.format(root=str(ROOT), modules=modules)],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    loaded = top_level_modules("portbench.run", "portbench.control", "portbench.reference",
                               "portbench.reference.grm", "portbench.reference.mixed_model")
    assert not loaded & {"jax", "jaxlib", "flax", "dissect_tpu"}


def test_a_units_program_calls_load_neither():
    """The program's modules a unit imports: every one the dispatcher does."""
    loaded = top_level_modules("portbench.run", "dissect_tpu_torch.analysis.dispatcher")
    assert "dissect_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "dissect_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, {root!r}); import portbench.reference.grm, "
            "portbench.reference.mixed_model, portbench.reference.genotypes, portbench.cohort; "
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))").format(
        root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"dissect_tpu_torch", "dissect_tpu", "jax", "jaxlib", "flax"}
