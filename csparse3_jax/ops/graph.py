"""Graph ops over sparsity patterns: connected components ("islands").

Reference: find_islands — a sequential non-recursive DFS with an explicit
stack over the CSC pattern (src/CSparse3/csc_numba.py:744-808) and its C++
BFS twin cs_graph_components (src/sparsetools/csgraph.h:12-74).

DFS/BFS do not vectorize; the device formulation is **min-label propagation
with pointer jumping** (a data-parallel union-find):

  label[v] <- min(label[v], min over neighbors u of label[u])   (segment_min)
  label    <- label[label]                                       (jumping)

iterated inside ``lax.while_loop`` until fixpoint.  Converges in
O(log(diameter)) rounds thanks to the pointer-jumping step; every round is
one gather + one segment_min over the edge stream.
"""

from __future__ import annotations

from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..types import CSC
from . import construct

__all__ = ["islands", "component_labels"]


@partial(jax.jit, static_argnums=(2,))
def _propagate(rows, cols, n):
    """Min-label propagation over undirected edges until fixpoint."""
    # symmetrize the edge stream
    src = jnp.concatenate([rows, cols])
    dst = jnp.concatenate([cols, rows])
    init = jnp.arange(n, dtype=jnp.int32)

    def cond(state):
        labels, changed = state
        return changed

    def body(state):
        labels, _ = state
        neigh_min = jax.ops.segment_min(labels[src], dst, num_segments=n)
        new = jnp.minimum(labels, neigh_min)
        # pointer jumping: follow the label chain one hop
        new = jnp.minimum(new, new[new])
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.asarray(True)))
    return labels


def component_labels(a: CSC):
    """Component id per node (0..n_components-1), treating the pattern of the
    square matrix A as an undirected graph."""
    if a.m != a.n:
        raise ValueError("islands expects a square (adjacency-like) matrix")
    k = a.nnz
    rows = a.indices[:k].astype(jnp.int32)
    cols = construct.expand_indptr(a.indptr, k).astype(jnp.int32)
    raw = _propagate(rows, cols, a.n)
    # renumber to 0..c-1 (host)
    raw_np = np.asarray(raw)
    _, labels = np.unique(raw_np, return_inverse=True)
    return labels


def islands(a: CSC) -> List[np.ndarray]:
    """List of node-index arrays, one per connected component
    (reference: CscMat.islands, csc.py:515-521 -> find_islands)."""
    if a.m == 0:
        return []
    labels = component_labels(a)
    order = np.argsort(labels, kind="stable")
    labels_sorted = labels[order]
    boundaries = np.flatnonzero(np.diff(labels_sorted)) + 1
    return [np.sort(part) for part in np.split(order, boundaries)]
