"""Newton-Krylov solver for fixed points (and periodic orbits).

Counterpart of ``src/Newton/NewtonKrylov.fypp``: Newton iteration
on ``F(X) = 0`` with the Jacobian re-linearized each step
(NewtonKrylov.fypp:346), the Newton system ``J dx = -r`` solved by an
*injected* linear solver (:349-352), an optional golden-section bisection
line search on the step length (4-point bracket, ``invphi``, at most
``maxstep_bisection`` extra residual evaluations, :355-359,422-525),
inexact-Newton tolerance schedulers ``constant_tol`` and ``dynamic_tol``
(``tol = max(0.1 * rnorm, target)``, :534-598), a lucky-convergence check on
entry (:325-332) and a final double-check at the target tolerance whenever
convergence was declared at a relaxed tolerance (:370-388).

The outer Newton loop is eager orchestration (it owns solver injection and
scheduling); every heavy step — residual evaluation, Jacobian matvec inside
the injected Krylov solver — is jitted device code.
"""

from __future__ import annotations

import math

import numpy as np

from .. import constants, vectors
from ..utils.logger import check_info, log_information, log_warning
from ..utils.options import NewtonOptions, NewtonMetadata
from ..utils.timer import count_applications, timed_fn
from .gmres import gmres

__all__ = ["newton", "constant_tol", "dynamic_tol"]


def constant_tol(target: float, rnorm: float, iteration: int) -> float:
    """Constant-tolerance scheduler (reference: ``constant_atol_*``,
    NewtonKrylov.fypp:534-560)."""
    return target


def dynamic_tol(target: float, rnorm: float, iteration: int) -> float:
    """Inexact-Newton scheduler ``tol = max(0.1 * rnorm, target)``
    (reference: ``dynamic_tol_*``, NewtonKrylov.fypp:562-598)."""
    return max(0.1 * rnorm, target)


_INVPHI = (math.sqrt(5.0) - 1.0) / 2.0


def _bisection_step(system, X, dx, f0, maxstep: int, atol: float,
                    record=None):
    """Golden-section line search on the step length ``alpha`` in [0, 1]
    minimizing ``||F(X + alpha dx)||`` (reference: ``increment_bisection``,
    NewtonKrylov.fypp:422-525 — 4-point bracket, ``invphi`` contraction,
    at most ``maxstep`` residual evaluations).

    Every ``system.eval`` performed here is counted against the system's
    operator counters and reported to ``record(rnorm, tol)`` so the metadata
    carries one ``(residual, tolerance)`` entry per *eval*, bisection
    included (reference: NewtonKrylov.fypp:44-65,221-242 — the metadata's
    ``record`` is called for each ``sys%eval``)."""

    def fnorm(alpha):
        Xt = vectors.axpby(1.0, X, alpha, dx)
        r = float(vectors.norm(system.eval(Xt, atol)))
        count_applications(system, 1, "eval")
        if record is not None:
            record(r, atol)
        return r

    a, b = 0.0, 1.0
    c = b - _INVPHI * (b - a)
    d = a + _INVPHI * (b - a)
    fc, fd = fnorm(c), fnorm(d)
    evals = 2
    f_full = f0
    while evals < maxstep:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - _INVPHI * (b - a)
            fc = fnorm(c)
        else:
            a, c, fc = c, d, fd
            d = a + _INVPHI * (b - a)
            fd = fnorm(d)
        evals += 1
    alpha = c if fc < fd else d
    # Never do worse than the full step (reference keeps the better of the two).
    if min(fc, fd) >= f_full:
        alpha = 1.0
    return alpha


@timed_fn("newton", "Newton")
def newton(system, X0, solver=None, rtol: float | None = None,
           atol: float | None = None, options: NewtonOptions | None = None,
           linear_solver_options=None, preconditioner=None, scheduler=None):
    """Newton-Krylov iteration for ``F(X) = 0`` ->
    ``(X, info, metadata)`` (reference: ``newton``,
    NewtonKrylov.fypp:246-420).

    ``solver(A, b, **kw) -> (x, info, meta)`` is any conforming linear
    solver (the reference's ``abstract_linear_solver`` interface,
    IterativeSolvers.fypp:102-131); defaults to :func:`gmres`.
    ``info = n_iter`` if converged else ``-n_iter``.
    """
    opts = options or NewtonOptions()
    if solver is None:
        solver = gmres
    dt = vectors.dtype_of(X0)
    rdt = constants.real_dtype_of(dt)
    if rtol is None:
        rtol = constants.rtol(rdt)
    if atol is None:
        atol = constants.atol(rdt)
    if scheduler is None:
        scheduler = dynamic_tol

    # one (residual, tolerance) entry per system.eval — bisection included
    # (reference: NewtonKrylov.fypp:44-65,221-242)
    eval_res: list[float] = []
    eval_tol: list[float] = []

    def record(r: float, t: float) -> None:
        eval_res.append(r)
        eval_tol.append(t)

    X = X0
    residual = system.eval(X, atol)
    count_applications(system, 1, "eval")
    rnorm = float(vectors.norm(residual))
    record(rnorm, atol)
    target = atol + rtol * max(rnorm, 1.0)

    converged = rnorm < target  # lucky convergence (:325-332)
    n_iter = 0

    for i in range(1, opts.maxiter + 1):
        if converged:
            break
        tol = scheduler(target, rnorm, i)

        J = system.jacobian(X, tol)  # re-linearize (:346)
        rhs = vectors.chsgn(residual)
        kw = {"atol": tol, "rtol": 0.0}
        if preconditioner is not None:
            kw["preconditioner"] = preconditioner
        if linear_solver_options is not None:
            kw["options"] = linear_solver_options
        dx, s_info, _ = solver(J, rhs, **kw)
        # reference routes the injected solver's info through check_info
        # (NewtonKrylov.fypp:352 -> Logger.f90:653-667: non-convergence of
        # the inner solve is a logged message, not fatal)
        check_info(s_info, getattr(solver, "__name__", "gmres"),
                   "solvers", "newton")

        if opts.ifbisect:
            alpha = _bisection_step(system, X, dx, rnorm,
                                    opts.maxstep_bisection, atol,
                                    record=record)
            X = vectors.axpby(1.0, X, alpha, dx)  # (:355-359)
        else:
            X = vectors.add(X, dx)

        # new residual, evaluated at the *scheduler* tolerance — adaptive
        # time-stepper responses integrate only as accurately as the inexact
        # Newton step requires (reference: sys%eval(X, residual, tol), :361)
        residual = system.eval(X, tol)
        count_applications(system, 1, "eval")
        rnorm = float(vectors.norm(residual))
        record(rnorm, tol)
        n_iter = i
        log_information(f"newton: iter {i}, |F| = {rnorm:.3e} (tol {tol:.1e})",
                        "solvers", "newton")
        if rnorm < tol and target <= tol < 100.0 * target:
            # converged at a (possibly relaxed) tolerance near the target:
            # re-evaluate the residual *accurately* and accept only if it
            # passes the target tolerance (reference: :369-387)
            residual = system.eval(X, target)
            count_applications(system, 1, "eval")
            rnorm = float(vectors.norm(residual))
            record(rnorm, target)
            if rnorm < target:
                converged = True
                log_information(
                    f"newton: converged after {i} iterations.",
                    "solvers", "newton")
            else:
                log_warning(
                    "newton: dynamic tolerance but not target tolerance "
                    "reached. Continue.", "solvers", "newton")

    if not converged:
        log_warning(f"newton: no convergence in {opts.maxiter} iterations "
                    f"(|F| = {rnorm:.3e})", "solvers", "newton")

    info = n_iter if converged else -max(n_iter, 1)
    meta = NewtonMetadata(
        converged=converged, n_iter=n_iter, info=info,
        n_evals=len(eval_res),
        residuals=np.asarray(eval_res), tolerances=np.asarray(eval_tol),
    )
    if opts.if_print_metadata:
        meta.print()
    return X, info, meta
