"""The harness without a card: a whole run of each unit on the CPU at a
small size (the program through its kernels' plain versions), with the
program broken underneath to see `correct` come out false; a cell, a
traffic mix, a configuration and a metric added by files alone; and the
exits without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 2024
# sizes at which the float64 program on the CPU meets each cell's limits
SMALL = {
    "array_gwas_scan": {"n_individuals": 800, "n_snps": 2500, "n_causal": 40},
    "imputed_gwas_scan": {"n_individuals": 800, "n_snps": 1200, "n_causal": 40},
    "array_reml": {"n_individuals": 400, "n_snps": 2000, "n_causal": 40},
    "array_make_grm": {"n_individuals": 300, "n_snps": 5000, "n_causal": 40},
}


def run_small(cell, root=ROOT, trace=False):
    result, _ = harness.run_cell(root, cell, SEED, 0.0, trace, "cpu", overrides=SMALL[cell])
    return result


@pytest.mark.parametrize("cell", list(SMALL))
def test_a_sound_run_is_correct(cell):
    result = run_small(cell)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "check"
    assert "setup_s" in result["metrics"]


# --- faults planted in the program ------------------------------------------
def fault_step_unchanged(monkeypatch, cell):
    """A step that returns its state unchanged."""
    if cell.endswith("gwas_scan"):
        from dissect_tpu_torch.gwas import mlm

        monkeypatch.setattr(mlm, "solve_spd_small", lambda f, g: g * 0)
    elif cell == "array_reml":
        from dissect_tpu_torch.reml.engine import REMLEngine

        quantities = REMLEngine._quantities

        def frozen(self, theta):
            out = dict(quantities(self, theta))
            out["grad"] = out["grad"] * 0
            return out

        monkeypatch.setattr(REMLEngine, "_quantities", frozen)
    else:
        from dissect_tpu_torch.linalg.syrk import grm_accumulator

        update = grm_accumulator.update

        def skip_first(self, *args):
            """Each build's first chunk leaves the accumulator as it was."""
            if getattr(self, "skipped", False):
                return update(self, *args)
            self.skipped = True
            return self

        monkeypatch.setattr(grm_accumulator, "update", skip_first)


def fault_half_batch(monkeypatch, cell):
    """Half of the batch left out, the result taken over the rest."""
    if cell.endswith("gwas_scan"):
        from dissect_tpu_torch.gwas import mlm

        refit = mlm.mlm_gwas_ml_refit

        def half(z, *args, **kw):
            z = z.clone()
            z[:, z.shape[1] // 2:] = 0
            return refit(z, *args, **kw)

        monkeypatch.setattr(mlm, "mlm_gwas_ml_refit", half)
    elif cell == "array_reml":
        from dissect_tpu_torch.io.phenotype import Phenotype
        from dissect_tpu_torch.reml import single

        init = single.SingleREML.__init__

        def half(self, kernels, pheno, *args, **kw):
            keep = len(pheno.keys) // 2
            pheno = Phenotype(keys=pheno.keys[:keep], values=pheno.values[:keep],
                              column=pheno.column)
            init(self, kernels, pheno, *args, **kw)

        monkeypatch.setattr(single.SingleREML, "__init__", half)
    else:
        from dissect_tpu_torch.analysis import dispatcher

        build = dispatcher.grm_from_plink

        def half(data, **kw):
            return build(data.filter(keep_snps=data.snp_names[: data.n_snps // 2]), **kw)

        monkeypatch.setattr(dispatcher, "grm_from_plink", half)


def fault_answer_altered(monkeypatch, cell):
    """One answer altered where it is produced."""
    if cell.endswith("gwas_scan"):
        from dissect_tpu_torch.gwas import mlm

        refit = mlm.mlm_gwas_ml_refit

        def altered(*args, **kw):
            res = refit(*args, **kw)
            res.snp_beta[-1] += res.snp_se[-1]
            return res

        monkeypatch.setattr(mlm, "mlm_gwas_ml_refit", altered)
    elif cell == "array_reml":
        from dissect_tpu_torch.reml import single

        compute = single.SingleREML.compute

        def altered(self, *args, **kw):
            out = compute(self, *args, **kw)
            out.blue = out.blue.copy()
            out.blue[0] += out.blue_se[0]
            return out

        monkeypatch.setattr(single.SingleREML, "compute", altered)
    else:
        from dissect_tpu_torch.analysis import dispatcher

        load = dispatcher.Analysis.load_grm

        def altered(self, *args, **kw):
            kern = load(self, *args, **kw)
            kern.matrix[-1, -2] += 1e-3
            return kern

        monkeypatch.setattr(dispatcher.Analysis, "load_grm", altered)


@pytest.mark.parametrize("fault", [fault_step_unchanged, fault_half_batch, fault_answer_altered])
@pytest.mark.parametrize("cell", list(SMALL))
def test_a_broken_program_is_not_correct(monkeypatch, cell, fault):
    """The faults a one-card cell can have (no exchange between cards
    here): each makes `correct` false."""
    fault(monkeypatch, cell)
    result = run_small(cell)
    assert not result["correct"], result["check"]
    assert result["failed"] >= 1


# --- adding by files alone -----------------------------------------------------
def test_a_cell_config_traffic_and_metric_are_added_by_files_alone(tmp_path):
    """A throwaway configuration, traffic mix, cell, limits and metric,
    each a new file under a root of its own plus BENCHMARK.json entries;
    the harness's code is untouched."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((ROOT / "portbench/configs/ukb_array_n20k.json").read_text())
    files = {
        "portbench/configs/tiny_array.json": {**base, "name": "tiny_array",
                                              **SMALL["array_make_grm"]},
        "portbench/traffic/grm_build_again.json": {"unit": "grm_build", "why": "a second mix"},
        "portbench/limits/tiny_make_grm.json": json.loads(
            (ROOT / "portbench/limits/array_make_grm.json").read_text()),
    }
    for rel, content in files.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(json.dumps(content))
    (tmp_path / "portbench/metrics").mkdir()
    (tmp_path / "portbench/metrics/grm.builds_per_min.py").write_text(
        "def read(run):\n    return 60.0 * run.units / run.window_s\n")
    bench["configs"].append({"name": "tiny_array", "source": "a test",
                             "file": "portbench/configs/tiny_array.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny_make_grm", "config": "tiny_array",
                               "traffic": "grm_build_again", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "grm.builds_per_min", "unit": "1/min",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny_make_grm"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = harness.run_cell(tmp_path, "tiny_make_grm", SEED, 0.0, False, "cpu")
    assert result["correct"]
    assert result["metrics"]["grm.builds_per_min"]["value"] > 0
    assert "peak_mem_gb" not in result["metrics"]  # no card: no device reading
    assert "setup_s" in result["metrics"]


# --- exits -----------------------------------------------------------------------
def test_no_card_means_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "array_make_grm",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_no_program_means_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "array_make_grm",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_the_forbidden_modules_are_named_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dissect_tpu_torch_like", object())
    assert "dissect_tpu_torch_like" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib.fake" in harness.forbidden_loaded()
