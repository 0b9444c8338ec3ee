"""Statistical distribution tails.

Parity: auxiliar.h:349-353 — chi1_CDF(df, x), FStatCDF(df1, df2, F),
tStatCDF(df, t) are upper-tail probabilities (the reference uses them as
p-values directly: p = 2*tStatCDF(df,|t|) in gwas.cpp:771, p =
chi1_CDF(1, chi2) in gwas.cpp:903).
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2 as _chi2
from scipy.stats import f as _f
from scipy.stats import t as _t


def chi2_sf(df, x):
    """Upper tail of chi-square (chi1_CDF, auxiliar.h:349)."""
    return _chi2.sf(np.asarray(x), df)


def t_sf(df, x):
    """Upper tail of Student t (tStatCDF, auxiliar.h:353)."""
    return _t.sf(np.asarray(x), df)


def f_sf(df1, df2, x):
    """Upper tail of F (FStatCDF, auxiliar.h:351)."""
    return _f.sf(np.asarray(x), df1, df2)
