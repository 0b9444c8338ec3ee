"""The PLINK .bim/.fam parse into columns (dissect_tpu_torch.io.bed).

`parse_bim`/`parse_fam` split a file whose every line is six
whitespace-separated tokens at once, and read any other file line by
line; either way they give columns (`TextColumns`) whose records equal
the JAX package's line parser's (`dissect_tpu.io.bed.read_bim`/
`read_fam`) field for field and type for type, and a file that parser
refuses is refused with its exception.  A PlinkData holds its tables as
columns, makes its records once, on first use, and filters and appends a
fileset read from files as one built from lists.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dissect_tpu.io.bed import read_bim, read_fam
from dissect_tpu_torch.io import bed
from dissect_tpu_torch.io.bed import (IndividualInfo, PlinkData, SnpInfo, TextColumns, parse_bim,
                                      parse_fam, read_plink, write_plink)
from dissect_tpu_torch.runtime.timers import timers
from tests.conftest import make_dosage

BIM = ["1\trs1\t0\t1000\tA\tG", "1\trs2\t0.5\t2000\tC\tT", "2\trs3\t1.25\t3000\tG\tA"]
FAM = ["F1 I1 0 0 1 -9", "F2 I2 F1 0 2 1.5", "F3 I3 0 0 0 -9"]


def lines(rows, end="\n"):
    return "".join(r + end for r in rows)


# name -> (.bim text, .fam text); blank lines, a seventh token and short
# .fam lines take the line-by-line read; a text-mode read ends a line at a
# lone CR, and str.split() splits at 0x1f and takes non-ASCII text, for
# the JAX parser and the columns alike
CASES = {
    "regular": (lines(BIM), lines(FAM)),
    "tabs_and_spaces": (
        "  1 \t rs1\t\t0 1000\tA   G\t\n1\trs2 0.5\t2000 C\tT\n\t2 rs3 1.25 3000 G A  \n",
        "F1\tI1\t0 0\t1\t-9\n  F2 I2  F1 0\t2 1.5\nF3 I3 0 0 0 -9 \t\n"),
    "crlf": (lines(BIM, "\r\n"), lines(FAM, "\r\n")),
    "no_final_newline": (lines(BIM)[:-1], lines(FAM)[:-1]),
    "empty": ("", ""),
    "blank_line": (lines(BIM[:1] + [""] + BIM[1:]), lines(FAM[:2] + [" \t "] + FAM[2:])),
    "bim_7_columns": (lines(r + "\textra" for r in BIM), lines(FAM)),
    "fam_2_columns": (lines(BIM), lines(" ".join(r.split()[:2]) for r in FAM)),
    # 12 tokens over two lines: the count is per line, not in total
    "seven_then_five_tokens": (lines(BIM), lines(["F1 I1 0 0 1 -9 x", "F2 I2 F1 0 2", FAM[2]])),
    "cm_forms": (lines(["1\trs1\t1e-3\t1000\tA\tG", "1\trs2\tnan\t2000\tC\tT",
                        "2\trs3\t-0\t3000\tG\tA"]), lines(FAM)),
    "bp_plus_sign": (lines(["1\trs1\t0\t+1000\tA\tG"] + BIM[1:]), lines(FAM)),
    "bp_with_underscore": (lines(["1\trs1\t0\t1_000\tA\tG"] + BIM[1:]), lines(FAM)),
    "bp_beyond_int64": (lines([f"1\trs1\t0\t{2 ** 70}\tA\tG"] + BIM[1:]), lines(FAM)),
    "lone_carriage_return": (lines(BIM, "\r"), lines(FAM)),
    "unit_separator": (lines(BIM), lines(["F1\x1fI1 0 0 1 -9"] + FAM[1:])),
    "non_ascii": (lines(BIM), lines(["Fé1 I1 0 0 1 -9"] + FAM[1:])),
}


def write(path, text):
    with open(path, "w", encoding="utf-8", newline="") as fh:
        fh.write(text)


def assert_same_records(got, want):
    """Field for field and type for type (repr tells -0.0 and nan apart);
    the port's records against the port's or the JAX package's."""
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert [f.name for f in dataclasses.fields(g)] == [f.name for f in dataclasses.fields(w)]
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            assert type(a) is type(b) and repr(a) == repr(b), (f.name, a, b)


def profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_timers():
    timers.reset()
    yield
    timers.reset()


@pytest.mark.parametrize("case", list(CASES))
def test_the_column_parse_gives_the_line_parsers_records(tmp_path, case):
    bim_text, fam_text = CASES[case]
    write(tmp_path / "c.bim", bim_text)
    write(tmp_path / "c.fam", fam_text)
    with profile():
        snps = parse_bim(str(tmp_path / "c.bim"))
        individuals = parse_fam(str(tmp_path / "c.fam"))
    assert_same_records(snps.records(), read_bim(str(tmp_path / "c.bim")))
    assert_same_records(individuals.records(), read_fam(str(tmp_path / "c.fam")))
    assert timers.summary()["counters"]["plink.text_bytes"] == (len(bim_text.encode())
                                                                + len(fam_text.encode()))
    assert snps.column("name") == [s.name for s in read_bim(str(tmp_path / "c.bim"))]


@pytest.mark.parametrize("suffix, text, error", [
    ("bim", lines(["1\trs1\t0\t5.0\tA\tG"]), ValueError),  # a position that int() refuses
    ("bim", lines(["1\trs1\tx\t5\tA\tG"]), ValueError),
    ("bim", lines(["1\trs1\t0\t5\tA\tG\textra", "1\trs2\t0\t6\tA"]), IndexError),  # 7 then 5
    ("fam", lines(["F1 I1 0 0 1 -9", "F2"]), TypeError),  # no IID
])
def test_a_bim_the_line_parser_refuses_is_refused_alike(tmp_path, suffix, text, error):
    path = str(tmp_path / f"c.{suffix}")
    write(path, text)
    reference, parse = (read_bim, parse_bim) if suffix == "bim" else (read_fam, parse_fam)
    with pytest.raises(error):
        reference(path)
    with pytest.raises(error):
        parse(path)


def test_a_cell_sized_parse_goes_by_columns(tmp_path):
    """The benchmark cohort's layout (tab-separated .bim, space-separated
    .fam, both six tokens a line): each file is split whole, at once."""
    m, n = 500, 300
    write(tmp_path / "c.bim", lines(f"{1 + i * 22 // m}\trs{i:07d}\t0\t{1000 + 100 * i}\tA\tG"
                                    for i in range(m)))
    write(tmp_path / "c.fam", lines(f"S{i} S{i} 0 0 0 -9" for i in range(n)))
    with profile():
        snps = parse_bim(str(tmp_path / "c.bim"))
        individuals = parse_fam(str(tmp_path / "c.fam"))
    for suffix in ("bim", "fam"):
        columns, _ = bed._split_text(str(tmp_path / f"c.{suffix}"), 6)
        assert columns is not None
    assert isinstance(snps, TextColumns) and isinstance(individuals, TextColumns)
    assert {type(v) for v in snps.column("position_bp")} == {int}
    assert {type(v) for v in snps.column("position_cm")} == {float}
    assert_same_records(snps.records(), read_bim(str(tmp_path / "c.bim")))
    assert_same_records(individuals.records(), read_fam(str(tmp_path / "c.fam")))


# --- the records, made on first use ------------------------------------------
SNPS = [SnpInfo(str(1 + i % 3), f"rs{i}", 0.25 * i, 1000 + i, "A", "G") for i in range(7)]
INDIVIDUALS = [IndividualInfo(f"F{i}", f"I{i}", "0", "0", str(i % 3), "-9") for i in range(5)]


@pytest.mark.parametrize("kind", ["snps", "individuals"])
def test_a_table_behaves_as_its_list(tmp_path, monkeypatch, kind):
    """A read fileset counts, names, keys and filters from its columns;
    its records are made once, on first use, as the plain list the line
    parser gives."""
    built = PlinkData(snps=SNPS, individuals=INDIVIDUALS,
                      _dosage=make_dosage(np.random.default_rng(1), 7, 5), device="cpu")
    write_plink(str(tmp_path / "c"), built)
    made = []
    records_of = TextColumns.records
    monkeypatch.setattr(TextColumns, "records", lambda self: made.append(self) or records_of(self))
    data = read_plink(str(tmp_path / "c"), device="cpu")
    kept = data.filter(keep_snps=["rs5", "rs1"], keep_individuals=["F3@I3", "F0@I0"])
    assert (data.n_snps, data.n_individuals, kept.n_snps, kept.n_individuals) == (7, 5, 2, 2)
    assert data.snp_names == built.snp_names and data.individual_keys == built.individual_keys
    assert kept.snp_names == ["rs5", "rs1"] and kept.individual_keys == ["F3@I3", "F0@I0"]
    assert made == []
    want = read_bim(str(tmp_path / "c.bim")) if kind == "snps" else read_fam(
        str(tmp_path / "c.fam"))
    got = getattr(data, kind)
    assert type(got) is list and getattr(data, kind) is got and len(made) == 1
    assert_same_records(got, want)
    assert_same_records(got[1:4] + got[:1], want[1:4] + want[:1])
    picks = [5, 1] if kind == "snps" else [3, 0]
    assert_same_records(getattr(kept, kind), [want[i] for i in picks])
    assert (data.n_snps, data.n_individuals) == (7, 5)


def test_a_table_from_records_keeps_their_values_as_they_are(tmp_path):
    """A PlinkData built from lists keeps their values as they are (an int
    cM, a position past int64), and picks from them when filtered."""
    snps = [SnpInfo("1", "a", 0, 2 ** 70, "A", "G"), SnpInfo("1", "b", 1.5, 7, "A", "G")]
    individuals = INDIVIDUALS[:3]
    data = PlinkData(snps=snps, individuals=individuals,
                     _dosage=make_dosage(np.random.default_rng(2), 2, 3), device="cpu")
    assert_same_records(data.snps, snps)
    assert_same_records(data.individuals, individuals)
    kept = data.filter(keep_snps=["b", "a"], keep_individuals=["F2@I2"])
    assert_same_records(kept.snps, [snps[1], snps[0]])
    assert kept.individuals == [individuals[2]]
    write_plink(str(tmp_path / "c"), data)
    read = read_plink(str(tmp_path / "c"), device="cpu")
    assert_same_records(data.append_snps(read).snps, snps + read_bim(str(tmp_path / "c.bim")))
    assert_same_records(read.append_snps(data).snps, read_bim(str(tmp_path / "c.bim")) + snps)


def plink_pair(tmp_path, name, seed, m=9, n=11):
    """A PlinkData built from lists of records, and the same fileset
    written and read back."""
    rng = np.random.default_rng(seed)
    snps = [SnpInfo(str(1 + i % 2), f"{name}{i}", 0.5 * i, 100 * i + 1, "A", "C")
            for i in range(m)]
    individuals = [IndividualInfo(f"F{i}", f"I{i}", "0", "0", "1", "-9") for i in range(n)]
    built = PlinkData(snps=snps, individuals=individuals,
                      _dosage=make_dosage(rng, m, n, missing_rate=0.05), device="cpu")
    prefix = str(tmp_path / name)
    write_plink(prefix, built)
    return built, read_plink(prefix, device="cpu")


def test_a_read_fileset_filters_and_appends_as_a_list_built_one(tmp_path):
    built, read = plink_pair(tmp_path, "a", 3)
    assert type(read.snps) is list and type(read.individuals) is list
    assert read.snps == built.snps and read.individuals == built.individuals
    assert read.snp_names == built.snp_names == [f"a{i}" for i in range(9)]
    assert read.individual_keys == built.individual_keys == [f"F{i}@I{i}" for i in range(11)]
    keep_snps, keep_ind = ["a4", "a0", "a7"], ["F9@I9", "F2@I2", "F5@I5"]
    for kw in ({"keep_snps": keep_snps}, {"keep_individuals": keep_ind},
               {"keep_snps": keep_snps, "keep_individuals": keep_ind}):
        got, want = read.filter(**kw), built.filter(**kw)
        assert_same_records(got.snps, want.snps)
        assert_same_records(got.individuals, want.individuals)
        assert got.snp_names == want.snp_names and got.individual_keys == want.individual_keys
        np.testing.assert_array_equal(got.dosages(), want.dosages())
    built_b, read_b = plink_pair(tmp_path, "b", 4)
    got, want = read.append_snps(read_b), built.append_snps(built_b)
    assert_same_records(got.snps, built.snps + built_b.snps)
    assert got.snp_names == want.snp_names and got.individual_keys == want.individual_keys
    np.testing.assert_array_equal(got.dosages(), want.dosages())
    # the names and keys handed out are copies: changing one leaves the data as it was
    read.snp_names.append("x")
    read.individual_keys.clear()
    assert read.n_snps == 9 and len(read.individual_keys) == 11


def test_each_read_parses_its_files_anew(tmp_path):
    """No parse is kept between calls: a .bim changed between two reads
    reads changed."""
    _, first = plink_pair(tmp_path, "a", 5)
    prefix = str(tmp_path / "a")
    with open(prefix + ".bim") as fh:
        text = fh.read()
    write(prefix + ".bim", text.replace("a3", "renamed"))
    with profile():
        second = read_plink(prefix, device="cpu")
    assert first.snp_names[3] == "a3" and second.snp_names[3] == "renamed"
    assert timers.summary()["spans"]["plink.read_text"]["count"] == 1
    assert read_bim(prefix + ".bim")[3].name == "renamed"
