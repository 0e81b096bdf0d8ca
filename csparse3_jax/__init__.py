"""csparse3-jax: a sparse linear-algebra framework in JAX.

Covers the full capability surface of the reference CSparse3 library
(CSC/COO/LIL containers, arithmetic, SpMV/SpMM, two-phase SpGEMM, slicing,
stacking, islands — reference: src/CSparse3/) plus sparse LU with pivoting
and triangular solves (the GridCal power-flow capability the reference left
unimplemented, see SURVEY.md scope note), built on XLA: segment-reduction,
gather and sort-based kernels, a block (BSR) compute format for
matrix-unit work, and jax.sharding distribution.
"""

from .utils.hostmem import tune_host_allocator as _tune_host_allocator

_tune_host_allocator()  # see utils/hostmem.py: sandboxed-host fault cost

from .__version__ import __version__  # noqa: F401
from . import config  # noqa: F401
from . import linalg, models, parallel  # noqa: F401
from .utils import io, profiling  # noqa: F401
from .builder import CooMat, LilMat, TripletBuilder  # noqa: F401
from .ops.arithmetic import (  # noqa: F401
    add,
    axpby,
    compare,
    eldiv,
    eliminate_zeros,
    elmul,
    equal,
    maximum,
    minimum,
    scale,
    scale_columns,
    scale_rows,
    sub,
)
from .ops.construct import (  # noqa: F401
    canonicalize,
    coo_to_csc,
    csc_to_bsr,
    csc_to_csr,
    csc_to_dia,
    csr_to_csc,
    dense_to_csc,
    dia_to_csc,
    diag,
    diags,
    expand_indptr,
    eye,
    from_triplets,
    random_csc,
    transpose,
)
from .ops.graph import component_labels, islands  # noqa: F401
from .ops.slicing import sample_offsets, sample_values, submatrix  # noqa: F401
from .ops.validate import has_canonical_format, has_sorted_indices, validate  # noqa: F401
from .ops.matvec import (  # noqa: F401
    DIAPlan,
    SplitDIA,
    SplitSpMV,
    SplitSymDIA,
    SpMVPlan,
    SymDIAPlan,
    bsr_spmm,
    dia_spmv,
    spmm,
    spmv,
)
from .ops.norms import norm  # noqa: F401
from .ops.reductions import diagonal, sum_duplicates  # noqa: F401
from .ops.spgemm import SpGEMMPlan, gram, spgemm, spgemm_symbolic  # noqa: F401
from .ops.spgemm_device import ESCSpGEMM, gram_device, spgemm_device  # noqa: F401
from .ops.bsr_ops import BSRMatMatPlan, bsr_add, bsr_matmat, bsr_transpose  # noqa: F401
from .ops.stacking import block, hstack, pack_4_by_4, vstack  # noqa: F401
from .types import BSR, COO, CSC, CSR, DIA  # noqa: F401
from .utils.misc import dense_to_str, slice_to_range  # noqa: F401

# Reference-compatible aliases (src/CSparse3/csc.py public surface)
CscMat = CSC
Diag = diag
Diags = diags


def scipy_to_mat(a) -> CSC:
    """Adopt a scipy CSC matrix (reference: scipy_to_mat, csc.py:541-553)."""
    return CSC.from_scipy(a)
