"""Checkpoint / resume (a copy of dissect_tpu/runtime/checkpoint.py).

The reference has no mid-iteration checkpointing; restarts happen at
artifact boundaries (.grm.* files, --initial-variances seeding from a
prior fit, precomputed mpresiduals matrices — SURVEY §5).  This module
keeps those boundaries (grm_io, LabeledMatrix) and adds what SURVEY
recommends on top: per-iteration REML state checkpoints so a preempted
long fit resumes from its last Newton step.

REML state is a tiny k-vector + scalars, so the format is plain JSON
(atomic rename); bulk array state (kernels, eigenvectors) continues to
live in the .grm.*/.dat artifacts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import List, Optional

import numpy as np
from dissect_tpu_torch.runtime.mesh import is_root


@dataclasses.dataclass
class REMLCheckpoint:
    iteration: int
    theta: np.ndarray
    log_likelihood: float
    variance_names: List[str]
    rel_diff: float = float("inf")

    def save(self, path: str):
        if not is_root():
            return
        payload = {
            "iteration": self.iteration,
            "theta": [float(t) for t in self.theta],
            "log_likelihood": self.log_likelihood,
            "variance_names": self.variance_names,
            "rel_diff": self.rel_diff,
        }
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> Optional["REMLCheckpoint"]:
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            payload = json.load(fh)
        return REMLCheckpoint(
            iteration=payload["iteration"],
            theta=np.asarray(payload["theta"], dtype=np.float64),
            log_likelihood=payload["log_likelihood"],
            variance_names=payload["variance_names"],
            rel_diff=payload.get("rel_diff", float("inf")),
        )


def read_initial_variances(path: str) -> dict:
    """--initial-variances file: 'name value' rows seeding a fit from a
    previous run (setVarianceInitialValuesFromFile,
    covariancematrix.cpp:1689, options.h:135)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 2:
                out[parts[0]] = float(parts[1])
    return out
