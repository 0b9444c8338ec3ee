"""Reduced-model refits and LRTs shared by the REML front ends.

Parity: computeREMLWithReducedModels (reml.cpp:1301-1400): reduced fits
start from the full-model estimates with the EM first step disabled
(reml.cpp:1319-1333); p = 0.5 * chi2_sf(LRT, df) (results.cpp:38-52).
Port of dissect_tpu/reml/reduced.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
from scipy.stats import chi2

from dissect_tpu_torch.model.covariance import CovarianceModel
from dissect_tpu_torch.reml.engine import REMLEngine, REMLOptions, REMLResult
from dissect_tpu_torch.runtime.log import result_open


def reduced_model_lrts(
    model: CovarianceModel,
    y: np.ndarray,
    x: np.ndarray,
    options: REMLOptions,
    full_result: REMLResult,
    elements_to_test: Sequence[str],
    include_blue: bool = False,
    engine_factory=None,
    device="cuda",
) -> List[dict]:
    """Refit with each named sub-covariance removed; LRT vs the full fit.

    include_blue additionally reports each reduced model's fixed-effect
    estimates (writeBLUEInReducedModels / --write-blue-reduced,
    options.cpp:725-729).  `engine_factory(model, y=, x=, options=)`
    lets callers route the refits to the same (e.g. distributed) engine
    as the full fit; without one the refits run on `device`."""
    reduced_opts = dataclasses.replace(options, first_step_em=False)
    if engine_factory is None:
        engine_factory = lambda model, y, x, options: REMLEngine(
            model, y, x, options, device=device
        )
    full_theta = dict(zip(full_result.variance_names, full_result.variances))
    lrts: List[dict] = []
    for sub_id in elements_to_test:
        reduced = model.delete_subcovariance(sub_id)
        if reduced.n_variances == 0 or not reduced.elements:
            continue
        init = np.array(
            [
                full_theta.get(nm, v.initial_value)
                for nm, v in zip(reduced.variance_names(), reduced.variances)
            ]
        )
        engine = engine_factory(reduced, y=y, x=x, options=reduced_opts)
        res = engine.fit(init)
        if res.success:
            blue = engine.compute_blue() if include_blue else None
            df = model.n_variances - reduced.n_variances
            lrt = max(2.0 * (full_result.log_likelihood - res.log_likelihood), 0.0)
            lrts.append(
                {
                    "removed": sub_id,
                    "log_likelihood": res.log_likelihood,
                    "lrt": lrt,
                    "df": df,
                    "p_value": 0.5 * float(chi2.sf(lrt, df)),
                    "converged": True,
                    "blue": blue,
                }
            )
        else:
            lrts.append(
                {
                    "removed": sub_id,
                    "log_likelihood": float("nan"),
                    "lrt": float("nan"),
                    "df": 0,
                    "p_value": float("nan"),
                    "converged": False,
                }
            )
    return lrts


def write_lrt_table(path: str, lrts: Sequence[dict]):
    """Write the reduced-model comparison table (Results output,
    results.cpp:38-90)."""
    with result_open(path + ".lrt") as fh:
        fh.write("REMOVED LOGL LRT DF PV CONVERGED\n")
        for row in lrts:
            fh.write(
                f"{row['removed']} {row['log_likelihood']:.8g} "
                f"{row['lrt']:.6g} {row['df']} {row['p_value']:.6g} "
                f"{int(row['converged'])}\n"
            )
