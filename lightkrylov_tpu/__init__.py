"""lightkrylov_tpu — a Krylov subspace framework in JAX for GPUs.

Brand-new JAX/XLA implementation with the capabilities of
nekStab/LightKrylov (reference: src/LightKrylov.fypp:89-131): Krylov
factorizations (Arnoldi, Lanczos, Golub-Kahan bidiagonalization), spectral
analysis (``eigs`` with Krylov-Schur restart, ``eighs``, ``svds``), linear
solvers (``gmres``, ``fgmres``, ``cg`` with right preconditioning), the
Krylov matrix exponential (``kexpm`` / ``krylov_exptA``) and a Newton-Krylov
solver for fixed points and periodic orbits.

Unlike the reference — which delegates all parallelism to user-supplied MPI
code — vectors here are sharded pytrees over a ``jax.sharding.Mesh``,
operators are XLA stencil/SpMV products with halo exchange, and every
Gram-Schmidt pass batches its inner products into a single fused all-reduce.

This umbrella module re-exports the public API, mirroring the reference's
``LightKrylov`` module (src/LightKrylov.fypp — ~121 public symbols).
"""

__version__ = "0.5.0"

from . import constants
from .constants import atol, rtol, get_rank, get_comm_size, io_rank

from .vectors import (
    dot,
    norm,
    scal,
    axpby,
    add,
    sub,
    chsgn,
    zero_like,
    rand_like,
    get_size,
    innerprod,
    gram,
    linear_combination,
    axpby_basis,
    zeros_basis,
    rand_basis,
    stack,
    unstack,
    get_column,
    set_column,
    basis_size,
    verify_vector_axioms,
)

from .linops import (
    LinearOperator,
    Preconditioner,
    MatvecOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    ScaledOperator,
    AdjointOperator,
    AxpbyOperator,
    ComposedOperator,
    adjoint,
    aslinop,
)

from .systems import System, JacobianOperator

from .krylov import (
    double_gram_schmidt_step,
    orthogonalize_against_basis,
    qr,
    qr_pivoted,
    cholesky_qr2,
    arnoldi,
    arnoldi_block,
    lanczos,
    bidiagonalization,
    krylov_schur,
    median_selector,
    permcols,
    invperm,
    initialize_krylov_subspace,
    initialize_random_orthonormal_basis,
    orthonormalize_basis,
    is_orthonormal,
)

from .solvers import (
    gmres,
    fgmres,
    cg,
    eigs,
    eighs,
    svds,
    save_eigenspectrum,
    kexpm,
    kexpm_mat,
    krylov_exptA,
    ExponentialPropagator,
    newton,
    constant_tol,
    dynamic_tol,
)

from .utils import linalg, logger, options, timer
from .utils.logger import logger_setup, check_info, LightKrylovError
from .utils.options import (
    GMRESOptions,
    CGOptions,
    EigsOptions,
    SVDSOptions,
    KexpmOptions,
    NewtonOptions,
)
from .utils.timer import global_watch, set_timing, time_lightkrylov, timed


def greetings() -> str:
    """Version banner (reference: ``greetings()``, LightKrylov.fypp:140-169)."""
    banner = f"lightkrylov_tpu v{__version__} — Krylov subspace methods in JAX"
    logger.log_message(banner)
    return banner
