"""Complex marshaling across the host<->device boundary as float pairs.

The framework's plan objects hold host numpy state that embeds as HLO
constants under closure-jit; user complex ARGUMENTS and RESULTS cross the
boundary through these helpers as real pairs, which the split-complex
device paths consume directly.

``splitc(fn)`` wraps a jittable ``fn`` so that every complex array in its
arguments and results crosses the boundary as a trailing-dim-2 float view
(a complex64 is bit-identical to 2 x float32, so the view is free) and is
reassembled on the other side:

    plan = lu.solve_plan()
    solve = jax.jit(splitc(plan))      # plan state embeds as constants
    x = unsplit(solve(split(b)))       # b complex -> floats -> complex

``split`` / ``unsplit`` are the host-side halves for hand-rolled call
sites.  All four are no-ops for real arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["split", "unsplit", "splitc"]

_PAIR = {np.dtype(np.complex64): np.float32,
         np.dtype(np.complex128): np.float64}


def split(x):
    """Host side, inbound: complex array -> real view with trailing dim 2.

    Works on pytrees; non-complex leaves pass through untouched."""

    def one(v):
        if isinstance(v, np.ndarray) and v.dtype in _PAIR:
            v = np.ascontiguousarray(v)
            return v.view(_PAIR[v.dtype]).reshape(v.shape + (2,))
        return v

    return jax.tree_util.tree_map(one, x)


def unsplit(x):
    """Host side, outbound: undo ``split`` on downloaded results."""

    def one(v):
        v = np.asarray(v)
        if (v.ndim >= 1 and v.shape[-1] == 2
                and v.dtype in (np.float32, np.float64)):
            cdt = np.complex64 if v.dtype == np.float32 else np.complex128
            return np.ascontiguousarray(v).view(cdt)[..., 0]
        return v

    return jax.tree_util.tree_map(one, x)


def _recombine(v):
    if (hasattr(v, "ndim") and v.ndim >= 1 and v.shape[-1] == 2
            and v.dtype in (jnp.float32, jnp.float64)):
        return jax.lax.complex(v[..., 0], v[..., 1])
    return v


def _decompose(v):
    if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.complexfloating):
        return jnp.stack([jnp.real(v), jnp.imag(v)], axis=-1)
    return v


def splitc(fn):
    """Wrap a jittable ``fn`` so complex args/results cross the boundary as
    float pairs.  Call it on ``split``-ed inputs and ``unsplit`` the result:
    ``unsplit(jax.jit(splitc(fn))(*split(args)))``.

    Caveat: inside the wrapper every trailing-dim-2 float input is treated
    as a packed complex pair — don't mix genuinely (…, 2)-shaped float
    arguments into a wrapped call."""

    def wrapped(*args, **kwargs):
        args, kwargs = jax.tree_util.tree_map(_recombine, (args, kwargs))
        out = fn(*args, **kwargs)
        return jax.tree_util.tree_map(_decompose, out)

    return wrapped
