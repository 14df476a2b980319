"""Typed options and metadata records for every solver.

Counterpart of the reference's ``abstract_opts`` /
``abstract_metadata`` hierarchy (reference: Utils.fypp:50-76) and the
per-solver records: ``gmres_*_opts`` (kdim=30, maxiter=10,
IterativeSolvers.fypp:141-151), ``cg_*_opts`` (maxiter=100, :468-474),
``newton_*_opts`` (maxiter=100, ifbisect, maxstep_bisection=5,
NewtonKrylov.fypp:28-39) and the matching metadata types carrying iteration
counts, residual histories and convergence flags
(IterativeSolvers.fypp:153-186,476-505; NewtonKrylov.fypp:44-65).

Metadata produced inside jitted solvers stores residual histories in
fixed-size device buffers; ``history`` trims them host-side.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "GMRESOptions",
    "CGOptions",
    "EigsOptions",
    "SVDSOptions",
    "KexpmOptions",
    "NewtonOptions",
    "SolverMetadata",
    "NewtonMetadata",
]


@dataclass(frozen=True)
class GMRESOptions:
    """(reference: ``gmres_{sp,dp}_opts``, IterativeSolvers.fypp:141-151).

    ``orthogonalization``: ``"dcgs2"`` (default) runs the delayed
    re-orthogonalization variant — one fused reduction and two basis
    streams per inner iteration instead of CGS2's two reductions and four
    streams, with the same two-pass orthogonality (the second pass is a
    fresh measurement, applied one iteration late and folded into the
    Hessenberg).  ``"cgs2"`` selects the classical reference scheme
    (gmres.fypp:167-169); FGMRES always uses it (flexible updates need the
    final basis column at preconditioning time).
    """

    kdim: int = 30          # dimension of the Krylov subspace per restart
    maxiter: int = 10       # number of restarts
    if_print_metadata: bool = False
    sanity_check: bool = True  # recompute the true residual each outer cycle
    orthogonalization: str = "dcgs2"


@dataclass(frozen=True)
class CGOptions:
    """(reference: ``cg_{sp,dp}_opts``, IterativeSolvers.fypp:467-474)."""

    maxiter: int = 100
    if_print_metadata: bool = False


@dataclass(frozen=True)
class EigsOptions:
    """Options for eigs/eighs (reference: defaults kdim = 4*nev, tol = rtol,
    IterativeSolvers.fypp:1023-1024).

    ``checkpoint_every``/``checkpoint_path``: serialize the factorization
    state (basis, projected matrix, restart indices, counters) every N
    convergence checks; the solver's ``resume_from=`` argument restores it
    — insurance against lost jobs that the reference lacks (its restart capability is
    algorithmic only; state is never persisted, SURVEY.md §5).
    """

    kdim: int | None = None       # None -> 4 * nev
    maxiter: int = 20             # max Krylov-Schur restart cycles
    write_intermediate: bool = False
    outpost: str = "eigs_output.txt"
    checkpoint_every: int = 0     # every N convergence checks; 0 = off
    checkpoint_path: str | None = None
    #: projected k x k eigensolve: "host" = LAPACK GEEV per check (the
    #: reference's path, IterativeSolvers.fypp:1065); "device" = jitted
    #: Francis QR + inverse-iteration eigvecs (utils/hessenberg.py) fused
    #: into the Arnoldi sweep — per-STEP convergence checks at zero host
    #: round-trips (real dtypes only); "auto" = device for eighs on any
    #: accelerator, host on the CPU, and host for eigs on every platform
    #: (ROADMAP A2).  Device mode also runs every RESTART on device: the
    #: IRAM exact-shift filter for the default selector, the jitted
    #: Schur + ordschur path (schur_real/ordschur_device) for custom
    #: selectors and the post-restart arrow form; host LAPACK remains the
    #: automatic fallback on filter/swap failure.
    projected: str = "auto"


@dataclass(frozen=True)
class SVDSOptions:
    kdim: int | None = None
    maxiter: int = 20
    checkpoint_every: int = 0     # every N convergence checks; 0 = off
    checkpoint_path: str | None = None
    #: projected k x k SVD: "host" LAPACK per check / "device" fused
    #: on-device per-step checks / "auto" = device on any accelerator,
    #: host on the CPU (see EigsOptions)
    projected: str = "auto"


@dataclass(frozen=True)
class KexpmOptions:
    """(reference: kdim=30 default wrapper, kmax=100; ExpmLib.fypp:149,365-392)."""

    kdim: int = 30


@dataclass(frozen=True)
class NewtonOptions:
    """(reference: ``newton_{sp,dp}_opts``, NewtonKrylov.fypp:28-39)."""

    maxiter: int = 100
    ifbisect: bool = False
    maxstep_bisection: int = 5
    if_print_metadata: bool = False


@dataclass
class SolverMetadata:
    """Iteration counts + residual history for the linear/eigen solvers
    (reference: ``gmres_*_metadata`` etc, IterativeSolvers.fypp:153-186)."""

    converged: bool = False
    n_iter: int = 0
    n_inner: int = 0
    info: int = 0
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def history(self) -> np.ndarray:
        """Residual history trimmed to executed iterations."""
        return self.residuals[: self.n_inner if self.n_inner else self.n_iter]

    def print(self, log_fn=print) -> None:
        log_fn(
            f"converged={self.converged} n_iter={self.n_iter} "
            f"n_inner={self.n_inner} final_res="
            f"{self.history[-1] if len(self.history) else float('nan'):.3e}"
        )

    def reset(self) -> None:
        self.converged = False
        self.n_iter = 0
        self.n_inner = 0
        self.info = 0
        self.residuals = np.zeros(0)


@dataclass
class NewtonMetadata:
    """(reference: ``newton_*_metadata`` recording (residual, tol) per eval,
    NewtonKrylov.fypp:44-65,221-242).

    ``residuals`` and ``tolerances`` are parallel arrays with one entry per
    ``system.eval`` call — the initial evaluation, every bisection
    line-search probe, each post-update residual, and target-tolerance
    recheck evaluations all appear, so ``n_evals == len(residuals)``
    matches the system's operator eval counter exactly.
    """

    converged: bool = False
    n_iter: int = 0
    n_evals: int = 0
    info: int = 0
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    tolerances: np.ndarray = field(default_factory=lambda: np.zeros(0))

    def print(self, log_fn=print) -> None:
        log_fn(
            f"newton: converged={self.converged} n_iter={self.n_iter} "
            f"residuals={np.array2string(self.residuals, precision=3)}"
        )
