"""Roofline / MFU accounting for the hot kernels.

BASELINE.md's per-chip bar is "% of roofline nnz/s"; this module supplies
the two ingredients:

  * ``measure_hbm_bw()`` — the ACHIEVABLE memory bandwidth of the
    device, measured (not quoted from a datasheet) with a jitted
    big-array copy chain using the same chained-delta method as
    ``bench.py`` (dispatch and transfer costs cancel in the delta).
  * ``plan_bytes(plan, *io)`` — the bytes-touched model of one kernel
    invocation: every device leaf of the plan read once, plus the
    explicit inputs/outputs.  This is the standard roofline convention
    (compulsory traffic; reuse inside the kernel only helps, so the
    reported %roofline is a lower bound).

``pct_roofline(bytes_touched, seconds, bw)`` then gives the fraction of
the memory roofline a measured kernel time achieves.  For compute-bound
kernels (the device factorization), ``tflops`` reports achieved
TFLOP/s from an analytic flop count instead.
"""

from __future__ import annotations

import time

import jax
import numpy as np

__all__ = ["measure_hbm_bw", "measure_matmul_f32", "traced_loop_s",
           "device_trace_events", "device_pids", "device_busy_s",
           "device_time_per_call", "plan_bytes", "pct_roofline", "tflops",
           "thomas_factor_flops"]


def measure_matmul_f32(n: int = 4096, reps: int = 32, trials: int = 3):
    """Achievable f32 ('highest' precision) matmul FLOP/s of the device.

    The compute-roofline denominator for the matmul-bound kernels (the
    banded solve sweeps are (s,s)@(s,B) chains at 'highest', i.e. full
    f32 without TF32 — the relevant peak is the MEASURED f32-matmul rate,
    not a datasheet tensor-core number).  Chained-delta over dependent
    matmuls.
    """
    import functools

    import jax.numpy as jnp

    x0 = jnp.eye(n, dtype=jnp.float32) * 1.0000001

    @functools.partial(jax.jit, static_argnums=1)
    def chain(x, R):
        with jax.default_matmul_precision("highest"):
            def body(c, _):
                y = c @ c
                return y / jnp.max(jnp.abs(y)), None

            o, _ = jax.lax.scan(body, x, None, length=R)
        return o[:2, :2]

    r1 = max(reps // 8, 1)
    c1 = chain.lower(x0, r1).compile()
    c2 = chain.lower(x0, reps).compile()
    per = None
    for _ in range(trials):
        t0 = time.perf_counter()
        np.asarray(c1(x0))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.asarray(c2(x0))
        t2 = time.perf_counter() - t0
        d = (t2 - t1) / (reps - r1)
        if d > 0 and (per is None or d < per):
            per = d
    return 2.0 * n ** 3 / per if per else 0.0


def traced_loop_s(cfun, args, R):
    """Device-timeline seconds-per-iteration of a compiled scan chain.

    Runs ``cfun(*args)`` once under ``jax.profiler.trace`` and returns
    (longest device-side while duration) / R — the same quantity the
    wall-clock chained delta estimates, but read off the device
    timeline, so it excludes host dispatch and can be compared with
    other traced rates on one timebase."""
    import tempfile

    td = tempfile.mkdtemp(prefix="roofline_trace")
    with jax.profiler.trace(td):
        np.asarray(cfun(*args))
    ev, dev = device_trace_events(td)
    loop = 0.0
    for e in ev:
        if (e.get("ph") == "X" and e.get("pid") in dev
                and e.get("name", "").startswith("while")):
            loop = max(loop, float(e.get("dur", 0.0)))
    if not loop:
        raise RuntimeError("no device while-loop event in trace")
    return loop / R / 1e6


def device_trace_events(trace_dir, cleanup=True):
    """Parse a ``jax.profiler.trace`` output directory.

    Returns (events, device_pids): the Chrome-trace event list of the
    newest profile and the pids of its GPU device tracks
    (``device_pids``).  ``cleanup`` removes the trace directory after
    parsing (traces accumulate tens of MB per bench run)."""
    import glob
    import gzip
    import json
    import shutil

    paths = sorted(glob.glob(f"{trace_dir}/**/*.trace.json.gz",
                             recursive=True))
    if not paths:
        raise RuntimeError(f"no trace under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        d = json.load(f)
    if cleanup:
        shutil.rmtree(trace_dir, ignore_errors=True)
    return d.get("traceEvents", []), device_pids(d)


def device_pids(trace: dict) -> set:
    """Pids of the GPU device tracks of a Chrome-format trace dict: the
    processes the profiler names ``/device:GPU:<i>`` (host threads are
    ``/host:CPU``)."""
    return {e.get("pid") for e in trace.get("traceEvents", [])
            if e.get("ph") == "M" and e.get("name") == "process_name"
            and str(e.get("args", {}).get("name", "")).startswith(
                "/device:GPU")}


def device_busy_s(events, pids) -> float:
    """Seconds in which at least one operation ran on the devices in
    ``pids``: the union of their complete ("X") events' intervals, so
    nested or concurrent events are counted once."""
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                for e in events
                if e.get("ph") == "X" and e.get("pid") in pids)
    busy, end = 0.0, float("-inf")
    for lo, hi in iv:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e6


def device_time_per_call(fn, args, reps: int = 50):
    """Device-busy seconds per call of the jitted ``fn(*args)``, read off
    a profiler trace of ``reps`` back-to-back calls (warm the shapes
    first: a compile inside the window would not show as device time)."""
    import tempfile

    jax.block_until_ready(fn(*args))
    td = tempfile.mkdtemp(prefix="device_time")
    with jax.profiler.trace(td):
        out = None
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
    ev, pids = device_trace_events(td)
    if not pids:
        raise RuntimeError("no GPU device track in the trace")
    return device_busy_s(ev, pids) / reps


def measure_hbm_bw(mb: int = 256, reps: int = 64, trials: int = 3):
    """Achievable device memory bandwidth in bytes/s.

    A jitted chain of dependent whole-array operations (y = x * s + c):
    each step reads and writes ``mb`` MB, so one step moves 2*mb MB.
    Chained-delta timing; completion forced by downloading one slice and
    checking it against the host expectation.
    """
    import functools

    import jax.numpy as jnp

    n = mb * (1 << 20) // 4
    x0 = jnp.ones((n,), jnp.float32)

    @functools.partial(jax.jit, static_argnums=1)
    def chain(x, R):
        def body(c, _):
            return c * 1.0000001 + 1e-9, None

        o, _ = jax.lax.scan(body, x, None, length=R)
        return o[:8]

    r1 = max(reps // 8, 1)
    c1 = chain.lower(x0, r1).compile()
    c2 = chain.lower(x0, reps).compile()
    per = None
    for _ in range(trials):
        t0 = time.perf_counter()
        np.asarray(c1(x0))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = np.asarray(c2(x0))
        t2 = time.perf_counter() - t0
        d = (t2 - t1) / (reps - r1)
        if d > 0 and (per is None or d < per):
            per = d
    expect = 1.0
    for _ in range(reps):
        expect = expect * 1.0000001 + 1e-9
    if not np.allclose(got, expect, rtol=1e-4):
        raise RuntimeError("bandwidth probe result mismatch")
    return 2.0 * mb * (1 << 20) / per if per else 0.0


def plan_bytes(plan, *io) -> int:
    """Compulsory bytes of one call: every device-array leaf of ``plan``
    (the operator's resident state) read once + each explicit ``io``
    array moved once."""
    total = 0
    for leaf in jax.tree_util.tree_leaves(plan):
        if hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        else:
            a = np.asarray(leaf)
            total += int(a.nbytes)
    for a in io:
        total += int(np.asarray(a).nbytes) if not hasattr(a, "nbytes") \
            else int(a.nbytes)
    return total


def pct_roofline(bytes_touched: int, seconds: float, bw: float) -> float:
    """Fraction of the measured memory roofline achieved."""
    if not (seconds and bw):
        return 0.0
    return (bytes_touched / seconds) / bw


def tflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e12 if seconds else 0.0


def thomas_factor_flops(nb: int, s: int) -> float:
    """Analytic flop count of the device block-Thomas factorization:
    per block, one (s,s) inverse (~2s^3 via LU+solves) and three (s,s)
    matmuls (2s^3 each)."""
    return nb * (2.0 + 3 * 2.0) * s ** 3
