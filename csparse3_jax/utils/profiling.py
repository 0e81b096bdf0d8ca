"""Profiling / observability.

The reference's only instrumentation is ad-hoc wall-clock prints in tests
(reference: src/test/test1_operations.py:25-49) and a realloc warning
inside the SpGEMM kernel (src/CSparse3/csc_numba.py:263).  SURVEY §5.1
prescribes the device equivalent: jax.profiler traces plus per-kernel nnz/s
counters in the same scipy-vs-ours spirit — this module provides both.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import jax
import numpy as np

__all__ = ["timeit", "Timer", "nnz_per_sec", "trace", "compare_with_scipy"]


def timeit(fn: Callable, *args, iters: int = 5, warmup: int = 2, **kw) -> float:
    """Median wall-clock of fn(*args) with device sync; returns seconds."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def nnz_per_sec(nnz: int, seconds: float) -> float:
    return nnz / seconds if seconds > 0 else float("inf")


@dataclass
class Timer:
    """Named section timer, printable as a table — the structured version
    of the reference tests' print-deltas."""

    records: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = [f"{'section':<32}{'calls':>6}{'total_s':>10}{'mean_ms':>10}"]
        for name, ts in self.records.items():
            lines.append(
                f"{name:<32}{len(ts):>6}{sum(ts):>10.3f}{1e3 * np.mean(ts):>10.2f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def compare_with_scipy(a, op: str = "spmv", iters: int = 5, seed: int = 0):
    """Time one of our kernels against scipy running the same op on host —
    the reference tests' scipy-vs-CSparse3 bundle (test1_operations.py),
    returned as a dict instead of printed."""
    import jax.numpy as jnp
    import scipy.sparse  # noqa: F401

    from ..ops.matvec import SpMVPlan
    from ..ops.spgemm import spgemm
    from ..ops.construct import transpose

    rng = np.random.RandomState(seed)
    s = a.to_scipy()
    out = {"op": op, "m": a.m, "n": a.n, "nnz": a.nnz}
    if op == "spmv":
        x = rng.rand(a.n)
        if np.iscomplexobj(s.data):
            x = x + 1j * rng.rand(a.n)
        plan = SpMVPlan(a)
        f = jax.jit(lambda p, v: p(v))
        xj = jnp.asarray(x)
        out["ours_s"] = timeit(f, plan, xj, iters=iters)
        sr = s.tocsr()
        t0 = time.perf_counter()
        for _ in range(iters):
            sr @ x
        out["scipy_s"] = (time.perf_counter() - t0) / iters
    elif op == "spgemm":
        t0 = time.perf_counter()
        c = spgemm(a, transpose(a))
        jax.block_until_ready(c.data)
        out["ours_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (s @ s.T).tocsc()
        out["scipy_s"] = time.perf_counter() - t0
    else:
        raise ValueError(f"unknown op {op!r}")
    out["speedup"] = out["scipy_s"] / out["ours_s"]
    out["nnz_per_s"] = nnz_per_sec(a.nnz, out["ours_s"])
    return out
