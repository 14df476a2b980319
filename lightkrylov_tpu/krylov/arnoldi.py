"""Arnoldi factorization ``A X_k = X_{k+1} H_k``.

Counterpart of ``src/Krylov/arnoldi.fypp``: block Arnoldi with
CGS2 orthogonalization against all previous columns, intra-block QR for
block size p > 1, incremental ``kstart/kend`` semantics for restart loops,
``transpose`` mode, and invariant-subspace breakdown signalled through
``info`` (reference: arnoldi.fypp:34-73; breakdown at :58-71).

Implementation: one jitted ``lax.while_loop`` with fixed-size stacked
buffers.  ``kstart``/``kend`` are *dynamic* device scalars so the same
compiled executable serves every Krylov-Schur restart cycle regardless of
the compression size (SURVEY.md §7 hard-parts list).  Unfilled buffer
columns are exactly zero, making unmasked CGS2 projections exact.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants, vectors
from ..utils.timer import count_applications, time_lightkrylov, timed_fn
from .gram_schmidt import double_gram_schmidt_step
from .qr import qr as _qr

__all__ = ["arnoldi", "arnoldi_block", "arnoldi_block_step", "arnoldi_step",
           "initialize_arnoldi", "initialize_arnoldi_block"]


def _count_steps(A, info, kstart, kend, n_per_step, kind):
    """Execution-accurate matvec counting for a standalone factorization
    call (reference brackets arnoldi itself: arnoldi.fypp:18,75).  Costs a
    host readback of ``info``, so only runs when ``time_lightkrylov()`` is
    on — free when instrumentation is disabled (same contract as the
    reference's timing guard)."""
    if not time_lightkrylov():
        return
    try:
        i, k0, k1 = int(info), int(kstart), int(kend)
    except (jax.errors.ConcretizationTypeError,
            jax.errors.TracerIntegerConversionError):  # traced: skip
        return
    stop = abs(i) if i != 0 else k1
    count_applications(A, max(0, stop - k0 + 1) * n_per_step, kind)


@partial(jax.jit, static_argnames=("kdim",))
def initialize_arnoldi(x0, kdim: int):
    """Allocate the (kdim+1)-column basis buffer and (kdim+1, kdim)
    Hessenberg, seeding column 0 with normalized ``x0`` (reference:
    ``initialize_krylov_subspace``, utilities.fypp:34-48).

    Jitted: one compiled executable serves every call."""
    dt = vectors.dtype_of(x0)
    X = vectors.zeros_basis(x0, kdim + 1)
    x0n = vectors.scal(1.0 / vectors.norm(x0), x0)
    X = vectors.set_column(X, 0, x0n)
    H = jnp.zeros((kdim + 1, kdim), dt)
    return X, H


@partial(jax.jit, static_argnames=("kdim", "p"))
def initialize_arnoldi_block(x0, kdim: int, p: int, key=None):
    """Allocate the ``(kdim + p)``-column basis buffer and
    ``(kdim + p, kdim)`` block Hessenberg, seeding the first block with
    ``x0`` plus ``p - 1`` random directions, orthonormalized by CGS2 QR
    (so column 0 spans ``x0`` exactly — the QR of ``[x0, r_1, ..]`` keeps
    the first column's direction).  Block counterpart of
    :func:`initialize_arnoldi` (reference:
    ``initialize_krylov_subspace``, utilities.fypp:34-48, blksize p > 1).
    """
    dt = vectors.dtype_of(x0)
    X = vectors.zeros_basis(x0, kdim + p)
    if p == 1:
        x0n = vectors.scal(1.0 / vectors.norm(x0), x0)
        X = vectors.set_column(X, 0, x0n)
    else:
        seed = vectors.zeros_basis(x0, p)
        if key is None:
            key = vectors.default_key()
        seed = vectors.rand_basis(key, seed)
        seed = vectors.set_column(seed, 0, x0)
        Q, _, _ = _qr(seed)
        X = vectors.set_columns_block(X, 0, Q)
    H = jnp.zeros((kdim + p, kdim), dt)
    return X, H


def arnoldi_step(A, X, H, k, transpose: bool = False, tol: float = 0.0):
    """One Arnoldi step: extend a k-column factorization to k+1
    (0-based ``k``; column ``k`` of X must be filled).

    Returns ``(X, H, beta)`` with ``H[:, k]`` the CGS2 coefficients,
    ``H[k+1, k] = beta`` and ``X[:, k+1]`` the next unit vector (zero on
    breakdown, keeping the buffer invariant) —
    (reference: arnoldi.fypp:34-73 for p = 1).
    """
    dt = vectors.dtype_of(X)
    xk = vectors.get_column(X, k)
    v = A.rmatvec(xk) if transpose else A.matvec(xk)
    # active-prefix CGS2: columns 0..k are filled
    v, proj = double_gram_schmidt_step(v, X, k=k + 1)
    beta = vectors.norm(v)
    ok = beta > tol
    inv = jnp.where(ok, 1.0 / jnp.where(beta == 0, 1.0, beta), 0.0)
    v = vectors.scal(inv.astype(constants.real_dtype_of(dt)), v)
    H = H.at[:, k].set(proj.astype(dt))
    H = H.at[k + 1, k].set(jnp.where(ok, beta.astype(dt), jnp.zeros((), dt)))
    X = vectors.set_column(X, k + 1, v)
    return X, H, beta


@timed_fn("krylov.arnoldi", "BaseKrylov")
def arnoldi(A, X, H, kstart=1, kend=None, transpose: bool = False, tol: float | None = None):
    """Grow the Arnoldi factorization from ``kstart`` to ``kend``
    (1-based, inclusive, matching the reference's calling convention,
    arnoldi.fypp:8-33).

    Returns ``(X, H, info)``: ``info = k`` (1-based) if an invariant
    subspace was found at step k (``beta <= tol``), else 0 —
    (reference: arnoldi.fypp:66-71).

    ``kstart``/``kend`` may be traced scalars; the loop is a
    ``lax.while_loop`` so a single compilation covers every restart cycle.
    """
    kdim = H.shape[1]
    if kend is None:
        kend = kdim
    dt = vectors.dtype_of(X)
    if tol is None:
        tol = constants.atol(constants.real_dtype_of(dt))

    kstart = jnp.asarray(kstart, jnp.int32)
    kend = jnp.asarray(kend, jnp.int32)

    def cond(carry):
        X, H, k, info = carry
        return (k < kend) & (info == 0)

    def body(carry):
        X, H, k, info = carry
        X, H, beta = arnoldi_step(A, X, H, k, transpose=transpose, tol=tol)
        info = jnp.where(beta <= tol, k + 1, info).astype(jnp.int32)
        # NaN beta: corrupt data, fatal negative info — `beta <= tol` is
        # False for NaN so it would otherwise propagate silently
        # (reference: qr.fypp:72-78 NaN sanitization)
        info = jnp.where(jnp.isnan(jnp.real(beta)), -(k + 1), info).astype(jnp.int32)
        return X, H, k + 1, info

    X, H, _, info = jax.lax.while_loop(
        cond, body, (X, H, kstart - 1, jnp.zeros((), jnp.int32))
    )
    _count_steps(A, info, kstart, kend, 1,
                 "rmatvec" if transpose else "matvec")
    return X, H, info


def arnoldi_block_step(A, X, H, s, p: int, transpose: bool = False,
                       tol: float = 0.0, key=None):
    """One BLOCK Arnoldi step at COLUMN offset ``s``: the newest filled
    block occupies columns ``s .. s+p-1``; extend the factorization by one
    block (columns ``s+p .. s+2p-1``).

    ``s`` need NOT be a multiple of ``p`` — a block Krylov-Schur restart
    keeps exactly the selected count ``n`` and continues with block starts
    at ``n, n+p, ...`` (offset-aligned continuation; at most ``p - 1``
    buffer columns per cycle go unused at the ``kdim`` boundary).
    Requires ``s <= kdim - p``.

    Matvecs the newest block as one batched kernel, CGS2-projects it
    against all ``s + p`` filled columns (filling ``H[:, s:s+p]``), then
    intra-block QR fills the subdiagonal coupling block at
    ``H[s+p:s+2p, s:s+p]``.  Returns ``(X, H, res)`` with ``res`` the
    smallest ``|diag(R)|`` of the new block (the block-breakdown
    indicator — reference: arnoldi.fypp:34-73 with blksize p > 1).
    Jittable; ``s`` may be a traced scalar.
    """
    dt = vectors.dtype_of(X)
    s = jnp.asarray(s, jnp.int32)
    blk_in = jax.tree.map(
        lambda l: jax.lax.dynamic_slice_in_dim(l, s, p, axis=0), X)
    blk = A.rmatvec_basis(blk_in) if transpose else A.matvec_basis(blk_in)
    blk, proj = double_gram_schmidt_step(blk, X, k=s + p)
    H = jax.lax.dynamic_update_slice(H, proj.astype(dt),
                                     (jnp.int32(0), s))
    Q, R, _ = _qr(blk, tol=tol, key=key)
    X = jax.tree.map(
        lambda l, q: jax.lax.dynamic_update_slice_in_dim(
            l, q.astype(l.dtype), s + p, axis=0),
        X, Q)
    H = jax.lax.dynamic_update_slice(H, R.astype(dt), (s + p, s))
    res = jnp.min(jnp.abs(jnp.diagonal(R)))
    return X, H, res


@timed_fn("krylov.arnoldi_block", "BaseKrylov")
def arnoldi_block(A, X, H, p: int, kstart=1, kend=None, transpose: bool = False,
                  tol: float | None = None, key=None):
    """Block Arnoldi with block size ``p``: at each block step, matvec the
    newest block, CGS2 against all previous columns filling
    ``H[:kp, kp-p:kp]``, then intra-block QR filling the subdiagonal block
    (reference: arnoldi.fypp:34-73 with blksize p > 1; residual = min diag
    of the new block's R).

    ``X`` holds ``kdim + p`` stacked columns, ``H`` is
    ``(kdim + p, kdim)`` with ``kdim = n_blocks * p``.  Like :func:`arnoldi`,
    ``kstart``/``kend`` may be *dynamic* (traced) scalars — the block loop is
    a jitted ``lax.while_loop``, so a single compiled executable serves every
    Krylov-Schur restart cycle (``kstart - 1`` and ``kend`` must be multiples
    of ``p``).  Returns ``(X, H, info)``.

    Note: the ``eigs`` driver is blksize-1 (matching the reference's eigs,
    IterativeSolvers.fypp:1030) — this block variant is a building block
    for user drivers and has no fused device sweep; compose it with the
    host projected path.
    """
    kdim = H.shape[1]
    assert kdim % p == 0, "kdim must be a multiple of the block size"
    n_blocks = kdim // p
    dt = vectors.dtype_of(X)
    if tol is None:
        tol = constants.atol(constants.real_dtype_of(dt))

    b0 = (jnp.asarray(kstart, jnp.int32) - 1) // p
    b1 = (jnp.asarray(n_blocks * p if kend is None else kend, jnp.int32)) // p

    def cond(carry):
        X, H, b, info = carry
        return (b < b1) & (info == 0)

    def body(carry):
        X, H, b, info = carry
        X, H, res = arnoldi_block_step(A, X, H, b * p, p,
                                       transpose=transpose, tol=tol, key=key)
        # breakdown: smallest diagonal of R below tol
        info = jnp.where((info == 0) & (res <= tol),
                         (b + 1) * p, info).astype(jnp.int32)
        # NaN: fatal negative info (reference: qr.fypp:72-78)
        info = jnp.where(jnp.isnan(res), -(b * p + 1), info).astype(jnp.int32)
        return X, H, b + 1, info

    X, H, _, info = jax.lax.while_loop(
        cond, body, (X, H, b0, jnp.zeros((), jnp.int32)))
    if time_lightkrylov():
        try:
            i, blk0, blk1 = int(info), int(b0) + 1, int(b1)
            stop = -(-abs(i) // p) if i != 0 else blk1  # ceil to block index
            count_applications(A, max(0, stop - blk0 + 1) * p,
                               "rmatvec" if transpose else "matvec")
        except (jax.errors.ConcretizationTypeError,
                jax.errors.TracerIntegerConversionError):  # traced: skip
            pass
    return X, H, info
