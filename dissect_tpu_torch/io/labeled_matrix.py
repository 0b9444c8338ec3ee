"""LabeledMatrix — a matrix with row/col string labels (a copy of
dissect_tpu/io/labeled_matrix.py whose `filter` finds labels through a
dict, not a list scan per label: the same result in linear time).

Parity: labeledmatrix.{h,cpp}.  Binary format (.rowids/.colids text,
.dat = 14-byte 'EFFECTS' header + column-major float64 payload,
labeledmatrix.cpp:434-490); loadRaw text tables with header
(labeledmatrix.cpp:101-160); label-based filtering via generalResorting
(labeledmatrix.cpp:380); insert/append (labeledmatrix.h:29-73).
Carrier for mpgwas residual matrices and group effects.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence

import numpy as np
from dissect_tpu_torch.runtime.log import output_open

_HEADER = b"EFFECTS" + bytes([0x5A, 0x99, 0x1, 0x1, 8, 0, 0])


def _positions(labels: Sequence[str], wanted: Sequence[str]) -> List[int]:
    """The first position of each wanted label (what list.index gives,
    without its scan per label); ValueError for a missing one."""
    at = {}
    for i, label in enumerate(labels):
        at.setdefault(label, i)
    missing = [w for w in wanted if w not in at]
    if missing:
        raise ValueError(f"{missing[0]!r} is not a label")
    return [at[w] for w in wanted]


@dataclasses.dataclass
class LabeledMatrix:
    row_labels: List[str]
    col_labels: List[str]
    values: np.ndarray  # (rows, cols) float64

    def __post_init__(self):
        self.values = np.asarray(self.values, dtype=np.float64)
        if self.values.shape != (len(self.row_labels), len(self.col_labels)):
            raise ValueError(
                f"matrix shape {self.values.shape} != labels "
                f"({len(self.row_labels)}, {len(self.col_labels)})"
            )

    # --- filtering (filterRowsAndCols, labeledmatrix.cpp:380) ---------------
    def filter(
        self,
        keep_rows: Sequence[str] = None,
        keep_cols: Sequence[str] = None,
    ) -> "LabeledMatrix":
        rows = list(keep_rows) if keep_rows is not None else self.row_labels
        cols = list(keep_cols) if keep_cols is not None else self.col_labels
        ri, ci = _positions(self.row_labels, rows), _positions(self.col_labels, cols)
        return LabeledMatrix(rows, cols, self.values[np.ix_(ri, ci)])

    def append_rows(self, other: "LabeledMatrix") -> "LabeledMatrix":
        if self.col_labels != other.col_labels:
            raise ValueError("column labels differ")
        return LabeledMatrix(
            self.row_labels + other.row_labels,
            self.col_labels,
            np.vstack([self.values, other.values]),
        )

    def center_columns(self) -> "LabeledMatrix":
        """Column centering (mpgwas residual preprocessing, gwasmp.cpp:143)."""
        return LabeledMatrix(
            self.row_labels,
            self.col_labels,
            self.values - self.values.mean(axis=0, keepdims=True),
        )

    # --- IO ------------------------------------------------------------------
    def save(self, prefix: str):
        with output_open(prefix + ".rowids", "w") as fh:
            fh.write("".join(l + "\n" for l in self.row_labels))
        with output_open(prefix + ".colids", "w") as fh:
            fh.write("".join(l + "\n" for l in self.col_labels))
        with output_open(prefix + ".dat", "wb") as fh:
            fh.write(_HEADER)
            fh.write(self.values.T.tobytes())  # column-major, ScaLAPACK layout

    @staticmethod
    def load(prefix: str) -> "LabeledMatrix":
        with open(prefix + ".rowids") as fh:
            rows = [l.strip() for l in fh if l.strip()]
        with open(prefix + ".colids") as fh:
            cols = [l.strip() for l in fh if l.strip()]
        with open(prefix + ".dat", "rb") as fh:
            header = fh.read(14)
            if header[:9] != _HEADER[:9]:
                raise ValueError(f"{prefix}.dat: invalid EFFECTS header")
            payload = np.frombuffer(fh.read(), dtype=np.float64)
        return LabeledMatrix(rows, cols, payload.reshape(len(cols), len(rows)).T)

    @staticmethod
    def load_raw(path: str, n_label_columns: int = 1) -> "LabeledMatrix":
        """Read a whitespace table with a header row; first
        `n_label_columns` columns are row labels joined with '@'
        (loadRaw, labeledmatrix.cpp:101-160)."""
        with open(path) as fh:
            lines = [l.split() for l in fh if l.strip()]
        header = lines[0]
        cols = header[n_label_columns:]
        rows, data = [], []
        for parts in lines[1:]:
            rows.append("@".join(parts[:n_label_columns]))
            data.append([float(v) for v in parts[n_label_columns:]])
        return LabeledMatrix(rows, cols, np.asarray(data))
