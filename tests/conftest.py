"""Test session setup.

Runs everything on a virtual 8-device CPU mesh (multi-device sharding
without a cluster, SURVEY §4) with x64 enabled so scipy float64 oracles
compare exactly.

CSPARSE3_TEST_PLATFORM=gpu leaves JAX on its default platform with x64 off
(the f32 device math the library runs on the GPU), for the tests marked
``gpu``; those skip, through the ``gpu`` fixture, wherever JAX finds no
GPU.  The exact-f64 oracle tests are written for the CPU mesh.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if os.environ.get("CSPARSE3_TEST_PLATFORM", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX runs on none.  Decided
    here, at run time, never at import: every xdist worker must collect
    the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture
def golden63():
    """The reference's canonical 6x3 CSC example
    (reference: test2_slicing.py:34-38, also documented at csc.py:52-87)."""
    data = np.array([4, 3, 3, 9, 7, 8, 4, 8, 8, 9], dtype=np.float64)
    indices = np.array([0, 1, 3, 1, 2, 4, 5, 2, 3, 4], dtype=np.int32)
    indptr = np.array([0, 3, 7, 10], dtype=np.int32)
    return sp.csc_matrix((data, indices, indptr), shape=(6, 3))


@pytest.fixture
def grid5_lines():
    """The reference's 5-bus / 7-branch line table
    (reference: test3_lil_matrix.py:18-24): columns F, T, R, X, B."""
    return [
        (3, 1, 0.05, 0.11, 0.02),
        (4, 3, 0.06, 0.13, 0.03),
        (5, 4, 0.04, 0.09, 0.02),
        (5, 2, 0.04, 0.09, 0.02),
        (5, 1, 0.03, 0.08, 0.02),
        (2, 1, 0.05, 0.11, 0.02),
        (2, 3, 0.04, 0.09, 0.02),
    ]


def rand_sp(m, n, density=0.05, seed=0, dtype=np.float64):
    rng = np.random.RandomState(seed)
    a = sp.random(m, n, density=density, random_state=rng, dtype=dtype, format="csc")
    a.sum_duplicates()
    return a


@pytest.fixture
def rand_pair():
    return rand_sp(60, 60, 0.08, seed=1), rand_sp(60, 60, 0.08, seed=2)


def assert_csc_equal(ours, ref, rtol=1e-12, atol=1e-14, pattern_exact=True):
    """Differential oracle: compare our CSC with a scipy sparse matrix."""
    import csparse3_jax as cst

    ref = sp.csc_matrix(ref)
    ref.sum_duplicates()
    ref.sort_indices()
    assert ours.shape == ref.shape, f"shape {ours.shape} != {ref.shape}"
    ip, ix, dt = ours.np_arrays()
    if pattern_exact:
        # our builds drop nothing, so patterns should match scipy's exactly
        # unless scipy kept explicit zeros we also keep — compare dense then
        if ours.nnz == ref.nnz:
            np.testing.assert_array_equal(ip, ref.indptr)
            np.testing.assert_array_equal(ix, ref.indices)
            np.testing.assert_allclose(dt, ref.data, rtol=rtol, atol=atol)
            return
    np.testing.assert_allclose(
        np.asarray(ours.todense()), ref.toarray(), rtol=rtol, atol=atol
    )


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Cap in-process compile accumulation: with this round's test volume
    (~290 tests) the XLA CPU compiler segfaults near the end of the full
    suite (deterministically at whatever test compiles next once the
    budget is hit; any half of the suite passes).  Dropping compiled
    executables between modules keeps the process under the cliff at the
    cost of some per-module recompiles."""
    yield
    jax.clear_caches()
