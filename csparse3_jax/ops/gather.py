"""Row gather + one-hot lane select: ``v[idx]`` in K-wide rows.

Reshaping the source to (E/K, K) rows, gathering whole rows by
``idx // K`` and selecting lane ``idx % K`` with a one-hot
multiply-reduce trades K times the bytes of a plain gather for
contiguous row moves.  It was built for an accelerator without a vector
gather unit; on the GPU a plain ``v[idx]`` is a native load, and
replacing this substrate is ROADMAP A3.

Shared by the SpGEMM numeric plans (ops/spgemm.py) and the multifrontal
factor extraction (linalg/multifrontal.py).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["ROWG_K", "rowgather"]

ROWG_K = 32


def rowgather(vals, idx, pad_to=None):
    """``vals[idx]`` via the row-DMA + lane-select substrate.

    ``pad_to`` (a multiple of ROWG_K, >= len(vals)) may be precomputed
    on host; defaults to the next multiple.  Exact for every dtype (the
    select multiplies by a 0/1 mask in the value dtype)."""
    K = ROWG_K
    if pad_to is None:
        pad_to = -(-max(int(vals.shape[0]), 1) // K) * K
    v = jnp.concatenate(
        [vals, jnp.zeros((pad_to - vals.shape[0],), vals.dtype)])
    rows = v.reshape(pad_to // K, K)
    q, r = idx // K, idx % K
    oh = (jnp.arange(K, dtype=idx.dtype)[None, :] == r[:, None])
    return jnp.sum(rows[q] * oh.astype(v.dtype), axis=1, dtype=v.dtype)
