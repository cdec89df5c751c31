"""conjugategradient_tpu — a device-resident sparse linear-algebra and iterative-solver
framework in JAX.

A from-scratch JAX / XLA / shard_map re-design of the capabilities of
aokomoriuta/ConjugateGradient (a CPU / CUDA+cuBLAS+cuSPARSE / handmade-OpenCL /
ViennaCL comparative CG study with multi-GPU row-block partitioning and halo
exchange):

- ``core``     — sparse formats (DIA / ELL / CSR / COO / dense), a DOK builder,
                 deterministic SPD problem generators, row-block partition math
                 with halo-range discovery, and a pure-numpy CPU oracle.
- ``ops``      — device BLAS-1 (dot / axpy / scal / norms in all three of the
                 reference's conventions), SpMV/SpMM for every format and
                 grid stencils — all plain XLA — plus the precision policy and
                 double-float arithmetic.
- ``solvers``  — a fully device-resident Krylov family complete by symmetry
                 class (CG/PCG, MINRES, BiCGStab, restarted GMRES, CGNR, the
                 dot-free Chebyshev iteration; ``lax.while_loop`` — scalars
                 never leave the device), mixed-precision iterative refinement,
                 deflation, multi-RHS block solves, LOBPCG, implicit-adjoint
                 differentiation through solves, convergence policy, residual
                 tracing, and eigen diagnostics.
- ``precond``  — Jacobi / block-Jacobi / Chebyshev / deflation and
                 geometric-multigrid V/W-cycles with hybrid transfers
                 (the "Mg" that the reference's name promises but never ships).
- ``parallel`` — mesh row-block sharding via ``shard_map`` and GSPMD: ``psum``
                 dots replace the reference's host-side ``Sum()`` allreduce and
                 ``ppermute`` halo shifts over the device interconnect replace its staged
                 device->host->device boundary copies; sixteen distributed designs
                 including communication-reduced variants.
- ``models``   — problem families: the reference's five benchmark workloads and
                 structured Poisson grids (1-D/2-D/3-D) for multigrid.
- ``utils``    — phase timers, structured residual logs, configuration.
- ``native``   — C++ host-side kit (format conversion, partition math, oracle
                 SpMV) loaded via ctypes, with pure-numpy fallbacks.

See SURVEY.md at the repo root for the full structural analysis of the
reference and citations of each capability being re-designed here.
"""

__version__ = "0.2.0"

from conjugategradient_tpu.core.formats import (  # noqa: F401
    BsrMatrix,
    CooMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
)
from conjugategradient_tpu.core.builder import DokBuilder  # noqa: F401
from conjugategradient_tpu.solvers.policy import ConvergencePolicy, Norm  # noqa: F401
from conjugategradient_tpu.solvers.cg import CGResult, cg_solve  # noqa: F401
from conjugategradient_tpu.api import eigs, solve  # noqa: F401
from conjugategradient_tpu import native  # noqa: F401
