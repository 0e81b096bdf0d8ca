"""Stacking vs scipy hstack/vstack (reference: test_matrix_stacking.py)."""

import numpy as np
import scipy.sparse as sp

import csparse3_jax as cst

from conftest import assert_csc_equal, rand_sp


def test_pack_4_by_4():
    # same construction scale/shape spirit as the reference test
    A = rand_sp(40, 50, 0.1, seed=0)
    B = rand_sp(40, 30, 0.1, seed=1)
    C = rand_sp(25, 50, 0.1, seed=2)
    D = rand_sp(25, 30, 0.1, seed=3)
    ours = cst.pack_4_by_4(*[cst.CSC.from_scipy(x) for x in (A, B, C, D)])
    ref = sp.hstack([sp.vstack([A, C]), sp.vstack([B, D])]).tocsc()
    assert_csc_equal(ours, ref)


def test_hstack_vstack():
    A = rand_sp(10, 5, 0.3, seed=4)
    B = rand_sp(10, 8, 0.3, seed=5)
    ours = cst.hstack([cst.CSC.from_scipy(A), cst.CSC.from_scipy(B)])
    assert_csc_equal(ours, sp.hstack([A, B]).tocsc())
    C = rand_sp(7, 5, 0.3, seed=6)
    ours_v = cst.vstack([cst.CSC.from_scipy(A), cst.CSC.from_scipy(C)])
    assert_csc_equal(ours_v, sp.vstack([A, C]).tocsc())


def test_block_with_none():
    A = rand_sp(4, 4, 0.5, seed=7)
    B = rand_sp(4, 3, 0.5, seed=8)
    ours = cst.block([[cst.CSC.from_scipy(A), cst.CSC.from_scipy(B)],
                      [cst.CSC.from_scipy(A), None]])
    ref = sp.bmat([[A, B], [A, None]]).tocsc()
    assert_csc_equal(ours, ref)
