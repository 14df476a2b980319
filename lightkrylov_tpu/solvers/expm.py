"""Krylov approximation of the matrix exponential action ``exp(tau A) b``.

Counterpart of ``src/Expm/ExpmLib.fypp``: incremental Arnoldi
with, per step, a dense ``expm`` of the *extended* (k+1) Hessenberg
``[[H_k, 0], [beta e_k^T, 0]]``; the approximation is
``beta0 * X[:, :k] @ E[:k, 0]`` and the error estimate the magnitude of the
last-row correction ``|beta0 * E[k, 0]|`` (conservative)
(reference: ExpmLib.fypp:189-220).  Invariant-subspace breakdown makes the
result exact and flags ``info = -2`` (:200-204).  ``krylov_exptA`` wraps a
fixed ``kdim = 30``, ``tol = atol`` configuration behind the
``abstract_exptA`` interface (:365-392); block version ``kexpm_mat`` with
QR of the input block (:234-363).

Structure: the whole iteration is one jitted ``lax.while_loop``.  The
projected exponential is computed on-device (XLA Pade expm) on the
*zero-padded* (kdim+1)^2 matrix: unfilled rows/columns are zero, so the
padded matrix is block-diagonal ``diag(Hext_k, 0)`` and its exponential's
top-left block is exactly ``exp(Hext_k)`` — no dynamic shapes, no host
round-trips.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants, vectors
from ..krylov.arnoldi import arnoldi_step, initialize_arnoldi
from ..linops import LinearOperator, aslinop
from ..utils import linalg
from ..utils.logger import check_info
from ..utils.options import KexpmOptions
from ..utils.timer import count_applications, timed_fn

__all__ = ["kexpm", "kexpm_mat", "krylov_exptA", "ExponentialPropagator"]


@partial(jax.jit, static_argnames=("kdim", "transpose"))
def _kexpm_impl(A, b, tau, tol, kdim, transpose):
    dt = vectors.dtype_of(b)
    rdt = constants.real_dtype_of(dt)
    beta0 = vectors.norm(b)
    X, H = initialize_arnoldi(b, kdim)
    atol_break = constants.atol(rdt)

    def cond(carry):
        X, H, k, err, broke = carry
        return (k < kdim) & (err >= tol) & jnp.logical_not(broke)

    def body(carry):
        X, H, k, err, broke = carry
        X, H, beta = arnoldi_step(A, X, H, k, transpose=transpose, tol=atol_break)
        broke = beta <= atol_break
        k = k + 1
        # Padded extended Hessenberg: (kdim+1)^2, block-diag(Hext_k, 0).
        Hsq = jnp.concatenate([H, jnp.zeros((kdim + 1, 1), dt)], axis=1)
        E = linalg.expm(jnp.asarray(tau).astype(dt) * Hsq)
        e_col = E[:, 0]
        err = (beta0 * jnp.abs(e_col[k])).astype(rdt)
        err = jnp.where(broke, jnp.zeros((), rdt), err)  # exact on breakdown
        return X, H, k, err, broke

    X, H, k, err, broke = jax.lax.while_loop(
        cond, body,
        (X, H, jnp.zeros((), jnp.int32), jnp.asarray(np.inf, rdt),
         jnp.zeros((), bool)),
    )

    # Reconstruct c = beta0 * X[:, :k] @ E[:k, 0] with the final k.
    Hsq = jnp.concatenate([H, jnp.zeros((kdim + 1, 1), dt)], axis=1)
    E = linalg.expm(jnp.asarray(tau).astype(dt) * Hsq)
    idx = jnp.arange(kdim + 1)
    coeff = jnp.where(idx < k, E[:, 0], jnp.zeros((), dt)) * beta0.astype(dt)
    c = vectors.linear_combination(X, coeff)
    return c, err, k, broke


@timed_fn("kexpm", "ExpmLib")
def kexpm(A, b, tau, tol: float | None = None, transpose: bool = False,
          kdim: int | None = None, options: KexpmOptions | None = None):
    """``c ~= exp(tau A) b`` -> ``(c, info)``.

    ``info = k`` (Krylov dimension used) on success, ``-2`` on
    invariant-subspace breakdown (result exact), ``-1`` if the error
    estimate never met ``tol`` within ``kdim`` steps
    (reference: ``kexpm``, ExpmLib.fypp:128-232).
    """
    A = aslinop(A)
    opts = options or KexpmOptions()
    if kdim is None:
        kdim = opts.kdim
    dt = vectors.dtype_of(b)
    rdt = constants.real_dtype_of(dt)
    if tol is None:
        tol = constants.atol(rdt)  # (reference: krylov_exptA default, :379)

    c, err, k, broke = _kexpm_impl(A, b, tau, jnp.asarray(tol, rdt), kdim, transpose)
    # one batched device_get (each separate scalar fetch is a host sync)
    err, k, broke = jax.device_get((err, k, broke))
    err, k, broke = float(err), int(k), bool(broke)
    if broke:
        info = -2
    elif err < tol:
        info = k
    else:
        info = -1
    count_applications(A, k, "rmatvec" if transpose else "matvec")
    check_info(info, "kexpm", "solvers", "kexpm")
    return c, info


class ExponentialPropagator(LinearOperator):
    """``exp(tau A)`` as a linear operator — the library-provided
    time-stepper for eigenanalysis of the exponential propagator
    (reference: ``krylov_exptA`` conforming to ``abstract_exptA_linop``,
    ExpmLib.fypp:365-392; AbstractLinops.fypp:105-123 carries ``tau``)."""

    _children = ("A", "tau")
    _static = ("kdim", "tol")

    def __init__(self, A, tau, kdim: int = 30, tol: float | None = None):
        self.A = aslinop(A)
        self.tau = jnp.asarray(tau)
        self.kdim = kdim
        self.tol = tol

    def _apply(self, x, transpose):
        dt = vectors.dtype_of(x)
        tol = self.tol if self.tol is not None else constants.atol(constants.real_dtype_of(dt))
        c, _, _, _ = _kexpm_impl(
            self.A, x, self.tau, jnp.asarray(tol, constants.real_dtype_of(dt)),
            self.kdim, transpose,
        )
        return c

    def matvec(self, x):
        return self._apply(x, False)

    def rmatvec(self, y):
        return self._apply(y, True)


@partial(jax.jit, static_argnames=("kdim", "p", "transpose"))
def _kexpm_mat_impl(A, B, tau, tol, kdim, p, transpose):
    from ..krylov.arnoldi import arnoldi_block
    from ..krylov.qr import qr as _qr

    dt = vectors.dtype_of(B)
    rdt = constants.real_dtype_of(dt)
    atol_break = constants.atol(rdt)

    # QR of the input block (reference: ExpmLib.fypp:234-270 — pivoted QR of
    # the rhs block; we use plain CGS2 QR, rank deficiency handled by the
    # random-replacement breakdown path with R recording the column norms).
    Q0, R0, _ = _qr(B)
    X = vectors.zeros_basis(vectors.get_column(B, 0), kdim + p)
    for i in range(p):
        X = vectors.set_column(X, i, vectors.get_column(Q0, i))
    H = jnp.zeros((kdim + p, kdim), dt)

    n_blocks = kdim // p
    err = jnp.asarray(np.inf, rdt)
    E_sq = jnp.zeros((kdim + p, kdim + p), dt)
    done = jnp.zeros((), bool)
    k_used = jnp.zeros((), jnp.int32)

    # Static block loop (block counts are small); convergence freezes state.
    for b_i in range(n_blocks):
        X_new, H_new, info = arnoldi_block(
            A, X, H, p, kstart=b_i * p + 1, kend=(b_i + 1) * p,
            transpose=transpose, tol=atol_break)
        X = jax.tree.map(lambda new, old: jnp.where(done, old, new), X_new, X)
        H = jnp.where(done, H, H_new)
        kp = (b_i + 1) * p
        # padded extended exponential: block-diag(Hext_kp, 0) (see _kexpm_impl)
        Hsq = jnp.zeros((kdim + p, kdim + p), dt).at[:, :kdim].set(H)
        E = linalg.expm(jnp.asarray(tau).astype(dt) * Hsq)
        # error estimate = || E[kp : kp+p, :p] @ R0 ||_2 (ExpmLib.fypp:341-350)
        Eblk = jax.lax.dynamic_slice(E, (jnp.int32(kp), jnp.int32(0)), (p, p))
        err_new = jnp.linalg.norm(jnp.matmul(
            Eblk, R0[:p, :p], precision=jax.lax.Precision.HIGHEST)).astype(rdt)
        E_sq = jnp.where(done, E_sq, E)
        err = jnp.where(done, err, err_new)
        k_used = jnp.where(done, k_used, kp)
        done = done | (err < tol) | (info > 0)

    # C = X[:, :kdim+p] @ E[:, :p] @ R0[:p, :p]
    coeff = jnp.matmul(E_sq[:, :p], R0[:p, :p].astype(dt),
                       precision=jax.lax.Precision.HIGHEST)  # (kdim+p, p)
    C = vectors.linear_combination(X, coeff)
    return C, err, k_used


def kexpm_mat(A, B, tau, tol: float | None = None, transpose: bool = False,
              kdim: int | None = None, options: KexpmOptions | None = None):
    """Block version: ``C ~= exp(tau A) B`` for a stacked block ``B`` of p
    columns -> ``(C, info)`` (reference: ``kexpm_mat``,
    ExpmLib.fypp:234-363 — QR of the input block, block Arnoldi, error
    ``||E[kp:kp+p, :p] R||_2``)."""
    A = aslinop(A)
    opts = options or KexpmOptions()
    p = vectors.basis_size(B)
    if kdim is None:
        kdim = opts.kdim
    kdim = -(-kdim // p) * p  # round up to a block multiple
    dt = vectors.dtype_of(B)
    rdt = constants.real_dtype_of(dt)
    if tol is None:
        tol = constants.atol(rdt)
    C, err, k_used = _kexpm_mat_impl(A, B, tau, jnp.asarray(tol, rdt), kdim, p,
                                     transpose)
    err, k_used = jax.device_get((err, k_used))
    err, k_used = float(err), int(k_used)
    info = k_used if err < tol else -1
    return C, info


def krylov_exptA(A, b, tau, transpose: bool = False, kdim: int = 30):
    """Fixed-configuration wrapper: ``exp(tau A) b`` at machine-precision
    tolerance (reference: ``krylov_exptA``, ExpmLib.fypp:365-392)."""
    c, _ = kexpm(A, b, tau, transpose=transpose, kdim=kdim)
    return c
