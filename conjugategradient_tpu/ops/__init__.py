"""Device ops: BLAS-1 (``ops.blas``), SpMV (``ops.spmv``), SpMM (``ops.spmm``),
grid stencils (``ops.stencil``), the precision policy and extended-precision
reductions (``ops.precision``), double-float arithmetic (``ops.dd``).

``ops.spmv`` is the *submodule*; the dispatching function is
``ops.spmv.spmv`` (also exported here as ``matvec`` to avoid shadowing).
"""

from conjugategradient_tpu.ops import blas, dd, precision, spmm, spmv, stencil  # noqa: F401
from conjugategradient_tpu.ops.blas import axpy, dot, max_abs, norm_l2, residual_norm, scal  # noqa: F401
from conjugategradient_tpu.ops.spmv import as_operator  # noqa: F401
from conjugategradient_tpu.ops.spmv import spmv as matvec  # noqa: F401
from conjugategradient_tpu.ops.spmm import spmm  # noqa: F401
