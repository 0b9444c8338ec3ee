"""The benchmark's inputs: drawn from the seed alone, and written in the
formats the program reads (checked against the program's readers)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.cohort import dosage_from_probs, make_cohort, pack_bed, quantize_probs
from portbench.reference.genotypes import decode_bed

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
SMALL = {"n_individuals": 90, "n_snps": 700, "n_causal": 12}


def config(name, **over):
    return {**json.loads((CONFIGS / f"{name}.json").read_text()), **SMALL, **over}


@pytest.mark.parametrize("name", ["ukb_array_n20k", "ukb_imputed_n20k"])
def test_the_same_seed_gives_the_same_inputs(tmp_path, name):
    a = make_cohort(config(name), 2**31 + 77, tmp_path / "a", "cpu")
    b = make_cohort(config(name), 2**31 + 77, tmp_path / "b", "cpu")
    c = make_cohort(config(name), 2**31 + 78, tmp_path / "c", "cpu")
    stored = lambda co: co.packed if co.kind == "plink" else co.probs
    assert np.array_equal(stored(a), stored(b))
    assert np.array_equal(a.traits, b.traits) and np.array_equal(a.qcov, b.qcov)
    assert not np.array_equal(stored(a), stored(c))
    four = make_cohort(config(name), 2**31 + 77, tmp_path / "d", "cpu", n_traits=4)
    assert np.array_equal(four.traits[:1], a.traits) and len(four.traits) == 4
    files = sorted(p.name for p in (tmp_path / "a").iterdir())
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes()


def test_the_bed_writer_round_trips_through_the_programs_reader(tmp_path):
    from dissect_tpu_torch.io.bed import read_plink

    co = make_cohort(config("ukb_array_n20k", n_individuals=91), 5, tmp_path, "cpu")
    data = read_plink(str(tmp_path / "cohort"), device="cpu")
    ours = decode_bed(torch.as_tensor(co.packed), co.n).numpy()
    assert np.array_equal(data.dosages(), ours)
    assert (ours == -1).mean() == pytest.approx(0.01, abs=0.005)
    assert data.individual_keys[:2] == ["F0@I0", "F1@I1"]


def test_pack_bed_codes():
    d = torch.tensor([[0, 1, 2, -1, 2]], dtype=torch.int8)
    assert pack_bed(d).tolist() == [[0b01111000, 0b00000011]]


def test_the_bgen_writer_round_trips_through_the_programs_reader(tmp_path):
    from dissect_tpu_torch.io.bgen import read_bgen

    co = make_cohort(config("ukb_imputed_n20k", n_snps=1100), 9, tmp_path, "cpu")
    data = read_bgen(str(tmp_path / "cohort.bgen"), device="cpu")
    ours = dosage_from_probs(torch.as_tensor(co.probs)).numpy()
    theirs = data.dosages.numpy()
    assert data.n_snps == co.m and data.individual_keys[0] == "S0@S0"
    assert np.array_equal(np.isnan(theirs), np.isnan(ours))
    ok = ~np.isnan(ours)
    assert np.abs(theirs[ok] - ours[ok]).max() <= 1e-6
    # most dosages are not whole numbers: the blur survives 8-bit rounding
    assert np.mean(ours[ok] == np.round(ours[ok])) < 0.5


def test_quantized_probabilities_keep_the_dosage():
    d = torch.tensor([[0.0, 0.2, 1.0, 1.2, 1.9, 2.0, float("nan")]])
    back = dosage_from_probs(quantize_probs(d))
    assert torch.isnan(back[0, -1])
    assert (back[0, :-1] - d[0, :-1].double()).abs().max() <= 1.0 / 255
