"""Global configuration for csparse3-jax.

The reference library has exactly one flag (``__config__.NATIVE``,
reference: src/CSparse3/__config__.py:1, read at src/CSparse3/csc.py:33-41)
that selects an AOT-compiled kernel backend over a JIT one.  The analogue
here is a small config object selecting

  * the compute backend for SpMV/SpMM: ``'xla'`` (pure jax/XLA, gather +
    segment ops) or ``'numpy'`` (host reference backend, used as a debug
    oracle the way the reference treats scipy),
  * index/value dtypes (the reference hard-codes int32/float64 in every
    numba signature, e.g. src/CSparse3/csc_numba.py:46,183,222 — here they
    are parameters, with int64 indices supported for >2^31-nnz problems,
    mirroring the overflow guard in src/sparsetools/csr.h:591-596),
  * the BSR tile shape of the internal block compute format.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class Config:
    # 'xla' | 'numpy'
    backend: str = "xla"
    # numpy dtypes for structure / values. jnp arrays follow these when the
    # enabled jax precision allows (x64 must be on for int64/float64).
    index_dtype: np.dtype = np.int32
    value_dtype: np.dtype = np.float64
    # tile of the internal BSR compute format (rows x cols); not yet tuned
    # for the GPU (ROADMAP)
    bsr_block: Tuple[int, int] = (8, 128)
    # Capacity growth factor for static-shape retry loops (the host-side
    # replacement for the kernel-side doubling realloc at
    # reference: src/CSparse3/csc_numba.py:261-278).
    growth: float = 2.0
    # Deterministic accumulation order (slower; for exact-equality debugging,
    # see SURVEY §7 "Numerical parity").
    deterministic: bool = False


_config = Config()


def get_config() -> Config:
    return _config


def update(**kw) -> Config:
    for k, v in kw.items():
        if not hasattr(_config, k):
            raise ValueError(f"unknown config field: {k}")
        setattr(_config, k, v)
    return _config


@contextlib.contextmanager
def config_ctx(**kw):
    old = {k: getattr(_config, k) for k in kw}
    try:
        update(**kw)
        yield _config
    finally:
        update(**old)

