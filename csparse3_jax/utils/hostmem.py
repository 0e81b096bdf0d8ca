"""Host allocator tuning.

On sandboxed / paravirtualized hosts (gVisor-class kernels), minor page
faults on freshly mmap'd anonymous memory can cost ~1000x a normal fault —
measured here: writing a fresh 30 MB ``np.empty`` buffer takes seconds,
while writing an already-touched buffer takes ~10 ms.  Since glibc hands
every allocation larger than ``mmap_threshold`` (default 128 KB) its own
fresh mmap and unmaps it on free, *every* large numpy temporary pays the
full fault cost — which makes allocation-heavy host code (orderings,
partition grouping, scipy oracles) look 100x slower than the machine is.

Fix: raise the malloc mmap/trim thresholds so large buffers come from the
brk heap and stay there after free.  Pages are then faulted once per
high-water mark and reused forever.  Safe everywhere (it is plain glibc
``mallopt``); a no-op on non-glibc platforms.

Applied automatically at ``import csparse3_jax`` (see package __init__).
"""

from __future__ import annotations

import ctypes

_M_MMAP_THRESHOLD = -3
_M_TRIM_THRESHOLD = -1

_applied = False


def tune_host_allocator(mmap_threshold: int = 1 << 30,
                        trim_threshold: int = 1 << 30) -> bool:
    """Apply mallopt tuning and the MAP_POPULATE numpy data allocator
    (native/npalloc.c, NEP 49, built on first use) — fresh numpy buffers then fault
    at memory speed instead of the sandbox's pathological per-page cost.
    Idempotent.  Returns True if the mallopt part applied.

    Set CSPARSE3_NO_HOSTMEM=1 to disable both.
    """
    global _applied
    if _applied:
        return True
    import os

    if os.environ.get("CSPARSE3_NO_HOSTMEM") == "1":
        return False
    try:
        libc = ctypes.CDLL(None)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, mmap_threshold)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, trim_threshold)
        _applied = bool(ok1 and ok2)
    except Exception:  # non-glibc platform
        _applied = False
    try:
        from ..native import ensure_built

        ensure_built("_npalloc.so")
        from ..native import _npalloc

        _npalloc.install()
    except ImportError:  # build failed — mallopt tuning still helps
        pass
    return _applied


def flush_subnormals(a, target="float32"):
    """Zero out (in place) entries whose magnitude is subnormal in the
    ``target`` dtype; returns ``a``.

    On this host, converting f64 data to f32 is ~100-300x slower when
    many values land in f32's subnormal range (measured: 65 s vs 0.25 s
    for a 618 MB stack) — each mixed-mantissa subnormal result takes a
    microcode assist that the sandbox makes catastrophically expensive.
    Factorization fill-in routinely decays into that range, so every
    host-side downcast of factor data should flush first.  Values below
    ~1.2e-38 are far beneath f32 solve precision, so this is numerically
    free.
    """
    import numpy as np

    a = np.asarray(a)
    if a.dtype == np.complex128 or a.dtype == np.complex64:
        flush_subnormals(a.real, target)
        flush_subnormals(a.imag, target)
        return a
    if not np.issubdtype(a.dtype, np.floating):
        return a
    tiny = np.finfo(target).tiny
    np.copyto(a, 0.0, where=np.abs(a) < tiny, casting="unsafe")
    return a
