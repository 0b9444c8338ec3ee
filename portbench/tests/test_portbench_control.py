"""The control of each cell's correctness check comes out not correct:
the plain reference one precision below what the configuration states,
held against the float64 reference by the cell's own comparison and
limits.  On the card (TF32 exists only there), at sizes a test run
holds; `portbench/control.py` reads it at the cells' own sizes."""

import pytest

from portbench.control import control_readings

# a fifth of the cells' individuals, and fewer SNPs
SMALLER = {
    "array_gwas_scan": {"n_individuals": 4000, "n_snps": 20000},
    "imputed_gwas_scan": {"n_individuals": 4000, "n_snps": 2000},
    "array_reml": {"n_individuals": 4000, "n_snps": 20000},
    "array_make_grm": {"n_individuals": 4000, "n_snps": 20000},
    "array_reml_mesh4": {"n_individuals": 4000, "n_snps": 20000},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", list(SMALLER))
def test_the_control_is_not_correct(card, root, cell):
    numbers, limits = control_readings(root, cell, 2**31 + 99, card, overrides=SMALLER[cell])
    assert [k for k, v in numbers.items() if not v <= limits[k]], numbers
