"""1-D block-row partitioning of sparse matrices across a device mesh.

The reference is single-process (SURVEY §2.4: no distribution anywhere);
this module is the scale-out axis mandated by the north star
(BASELINE.json): *row/block-partition the matrix and exchange halo vector
entries via ICI collectives overlapped with compute*.

Design:

* Rows are split into ``S`` contiguous blocks of ``mloc = ceil(m/S)`` rows
  (zero-padded to ``S * mloc``).  Shard ``s`` owns rows
  ``[s*mloc, (s+1)*mloc)`` of the matrix and the matching slice of every
  vector.

* Entries are regrouped **by ring distance**: an entry (i, j) on shard
  ``s = i // mloc`` whose column block is ``c = j // mloc`` has offset
  ``d = c - s``.  All entries with the same ``d`` can be computed as soon
  as the x-slice of shard ``s + d`` has arrived, so a SpMV is::

      y  = A[d=0] @ x_local                       # pure local, no comms
      for step in 1..k:                            # k = max |d| (static)
          x_fwd = ppermute(x_fwd, +1)              # halo from shard s-step
          x_bwd = ppermute(x_bwd, -1)              # halo from shard s+step
          y += A[d=-step] @ x_fwd + A[d=+step] @ x_bwd

  The local contraction between permute steps is what hides ICI latency
  (the XLA scheduler overlaps the collective with the gather/segment-sum).
  For matrices ordered to be banded (RCM, models/grids Ybus cases) k is 1,
  so a SpMV costs exactly one bidirectional neighbor exchange.

* Entry groups are padded to a static per-(shard, offset) width; padding
  uses row id ``mloc`` (one dummy slot past the local block) and value 0,
  so it vanishes in the scatter-add.  All shapes static → one compile.

For matrices whose structure is NOT banded (2k+1 >= S), the partition
falls back to an all-gather strategy: one ``all_gather(x)`` plus a single
local contraction with *global* column ids.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..types import CSC

__all__ = ["RowPartition", "partition_rows"]


def _entry_streams_np(a: CSC):
    ip, ix, dt = a.np_arrays()
    cols = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(ip))
    return ix.astype(np.int64), cols, dt


@jax.tree_util.register_pytree_node_class
class RowPartition:
    """Device-resident block-row partition of a square sparse matrix.

    Leaves (sharded over the mesh axis on their leading dim ``S``):

    * ring strategy: ``e_rows/e_cols/e_vals`` with shape (S, 2k+1, E) —
      local row ids, source-block-local col ids, values per ring offset.
    * allgather strategy: shapes (S, E) with *global* column ids.

    Static aux: (m, n, S, mloc, k, strategy).
    """

    def __init__(self, m, n, S, mloc, k, strategy, e_rows, e_cols, e_vals):
        self.m, self.n, self.S, self.mloc, self.k = m, n, S, mloc, k
        self.strategy = strategy
        self.e_rows = e_rows
        self.e_cols = e_cols
        self.e_vals = e_vals

    # pytree
    def tree_flatten(self):
        return (self.e_rows, self.e_cols, self.e_vals), (
            self.m, self.n, self.S, self.mloc, self.k, self.strategy,
        )

    @classmethod
    def tree_unflatten(cls, aux, ch):
        obj = object.__new__(cls)
        obj.m, obj.n, obj.S, obj.mloc, obj.k, obj.strategy = aux
        obj.e_rows, obj.e_cols, obj.e_vals = ch
        return obj

    def __repr__(self):
        return (
            f"RowPartition(m={self.m}, S={self.S}, mloc={self.mloc}, "
            f"k={self.k}, strategy={self.strategy!r})"
        )

    @property
    def m_pad(self) -> int:
        return self.S * self.mloc

    # -- vector layout helpers (host) ---------------------------------------
    def pad_vector(self, x):
        """Zero-pad a length-m (or (m, B)) array to m_pad rows."""
        x = jnp.asarray(x)
        pad = self.m_pad - x.shape[0]
        if pad == 0:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    def trim_vector(self, x):
        return x[: self.m]


def partition_rows(
    a: CSC,
    S: int,
    strategy: Optional[str] = None,
    row_block: int = 8,
) -> RowPartition:
    """Build a RowPartition of square ``a`` across ``S`` shards.

    strategy: 'ring' | 'allgather' | None (auto: ring iff the halo radius
    k keeps ring traffic below a full gather, i.e. 2k < S - 1).
    row_block: round mloc up to this multiple (sublane alignment).
    """
    if a.m != a.n:
        raise ValueError(
            f"row partition requires a square matrix for SpMV, got {a.shape}"
        )
    m = a.m
    mloc = -(-m // S)
    mloc = -(-mloc // row_block) * row_block
    rows, cols, vals = _entry_streams_np(a)

    shard = rows // mloc
    col_shard = cols // mloc
    d = col_shard - shard
    k = int(np.abs(d).max()) if len(d) else 0
    if strategy is None:
        strategy = "ring" if 2 * k < S - 1 else "allgather"

    if strategy == "allgather":
        # one group per shard, global column ids
        counts = np.bincount(shard, minlength=S)
        E = max(int(counts.max()) if counts.size else 1, 1)
        er = np.full((S, E), mloc, dtype=np.int32)
        ec = np.zeros((S, E), dtype=np.int32)
        ev = np.zeros((S, E), dtype=vals.dtype)
        order = np.argsort(shard, kind="stable")
        offs = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(rows)) - offs[shard[order]]
        er[shard[order], slot] = (rows[order] - shard[order] * mloc).astype(np.int32)
        ec[shard[order], slot] = cols[order].astype(np.int32)
        ev[shard[order], slot] = vals[order]
        return RowPartition(
            m, a.n, S, mloc, k, "allgather",
            jnp.asarray(er), jnp.asarray(ec), jnp.asarray(ev),
        )

    if strategy != "ring":
        raise ValueError(f"unknown partition strategy {strategy!r}")

    G = 2 * k + 1
    gid = shard * G + (d + k)  # flat (shard, offset-group) id
    counts = np.bincount(gid, minlength=S * G)
    E = max(int(counts.max()) if counts.size else 1, 1)
    er = np.full((S * G, E), mloc, dtype=np.int32)
    ec = np.zeros((S * G, E), dtype=np.int32)
    ev = np.zeros((S * G, E), dtype=vals.dtype)
    order = np.argsort(gid, kind="stable")
    gs = gid[order]
    offs = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(rows)) - offs[gs]
    er[gs, slot] = (rows[order] - shard[order] * mloc).astype(np.int32)
    ec[gs, slot] = (cols[order] - col_shard[order] * mloc).astype(np.int32)
    ev[gs, slot] = vals[order]
    return RowPartition(
        m, a.n, S, mloc, k, "ring",
        jnp.asarray(er.reshape(S, G, E)),
        jnp.asarray(ec.reshape(S, G, E)),
        jnp.asarray(ev.reshape(S, G, E)),
    )
