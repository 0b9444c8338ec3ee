"""Trace identities — avoiding O(N^3) products inside the REML loop.

Parity: Matrix::traceOfMatrixProduct computes tr(A B) as the elementwise
sum A .* B^T, never forming the product (matrix.cpp:3835-3918);
Matrix::diagonalOfABAt computes diag(A B A^T) as the row sums of
(A B) .* A (matrix.cpp:3920-3960).  Port of dissect_tpu/linalg/traces.py.
"""

from __future__ import annotations

import torch


def trace_of_product(a, b):
    """tr(a @ b) = sum(a * b.T) without forming the product."""
    return torch.sum(a * b.T)


def trace_of_product_symmetric(a, b):
    """tr(a @ b) when either operand is symmetric: sum(a * b)."""
    return torch.sum(a * b)


def diag_of_abat(a, b):
    """diag(A B A^T) as the row sums of (A B) .* A: one n x n product,
    nothing of size n^3."""
    return ((a @ b) * a).sum(1)


def diag_of_aat(a):
    """diag(A A^T) = row squared norms."""
    return (a * a).sum(1)
