"""Block composition: hstack / vstack / block / pack_4_by_4.

Reference: csc_stack_4_by_4_ff (src/CSparse3/csc_numba.py:640-720) and the
module helper pack_4_by_4 (src/CSparse3/csc.py:588-606), tested against
scipy hstack(vstack(...)) in src/test/test_matrix_stacking.py.

Device formulation: stacking is pure triplet relabeling — shift each block's
(row, col) ids by its block origin, concatenate the streams, and run one
sort-based CSC build.  Generalizes to arbitrary block grids, not just 2x2.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..types import CSC
from . import construct

__all__ = ["hstack", "vstack", "block", "pack_4_by_4"]


def block(grid: Sequence[Sequence[Optional[CSC]]]) -> CSC:
    """Assemble a block matrix from a 2-D grid of CSC blocks (None = zero
    block).  Row/col dims are inferred per block row/column and checked."""
    nrows = len(grid)
    ncols = len(grid[0])
    if any(len(r) != ncols for r in grid):
        raise ValueError("ragged block grid")
    row_h = [-1] * nrows
    col_w = [-1] * ncols
    for i, r in enumerate(grid):
        for j, b in enumerate(r):
            if b is None:
                continue
            if row_h[i] == -1:
                row_h[i] = b.m
            elif row_h[i] != b.m:
                raise ValueError(f"block ({i},{j}) height {b.m} != {row_h[i]}")
            if col_w[j] == -1:
                col_w[j] = b.n
            elif col_w[j] != b.n:
                raise ValueError(f"block ({i},{j}) width {b.n} != {col_w[j]}")
    if any(h == -1 for h in row_h) or any(w == -1 for w in col_w):
        raise ValueError("a full block row/column is None; dims unknown")
    row_off = np.concatenate([[0], np.cumsum(row_h)])
    col_off = np.concatenate([[0], np.cumsum(col_w)])
    rows_l, cols_l, vals_l = [], [], []
    for i, r in enumerate(grid):
        for j, b in enumerate(r):
            if b is None or b.nnz == 0:
                continue
            ip, rows, vals = b.np_arrays()
            rows_l.append(rows.astype(np.int64) + row_off[i])
            cols_l.append(
                construct.expand_indptr_np(ip).astype(np.int64) + col_off[j]
            )
            vals_l.append(vals)
    shape = (int(row_off[-1]), int(col_off[-1]))
    if not rows_l:
        return construct.from_triplets(
            np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0), shape
        )
    return construct.from_triplets(
        np.concatenate(rows_l), np.concatenate(cols_l), np.concatenate(vals_l), shape
    )


def hstack(mats: Sequence[CSC]) -> CSC:
    return block([list(mats)])


def vstack(mats: Sequence[CSC]) -> CSC:
    return block([[m] for m in mats])


def pack_4_by_4(a11: CSC, a12: CSC, a21: CSC, a22: CSC) -> CSC:
    """[[A11, A12], [A21, A22]] (reference: pack_4_by_4, csc.py:588-606)."""
    return block([[a11, a12], [a21, a22]])
