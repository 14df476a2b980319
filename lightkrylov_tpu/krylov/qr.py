"""QR factorization of a stacked basis, with and without column pivoting.

Counterpart of ``src/Krylov/qr.fypp``: in-place CGS2 QR of an
array-of-vectors with breakdown handling — a collinear column is replaced by
a random vector re-orthogonalized against the processed columns, the
diagonal entry is zeroed and ``info`` records the event
(qr.fypp:116-167) — plus rank-revealing pivoted QR with running column
norms and max-pivot column swapping (qr.fypp:32-107,176-202).

Everything runs inside one jitted ``fori_loop`` over columns with fixed-size
buffers; random replacement candidates are drawn ahead of the loop so the
RNG stays functional.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import constants, vectors
from ..utils.timer import timed_fn
from .gram_schmidt import double_gram_schmidt_step

__all__ = ["qr", "qr_pivoted", "cholesky_qr2"]


@jax.jit
def _cholqr_pass(X):
    """One CholeskyQR pass: ``X = Q R`` with ``R = chol(X^H X)^H``.

    Two matmuls (Gram + coefficient application) and — on a sharded
    mesh — exactly ONE fused all-reduce (inside ``gram``); contrast with
    the CGS2 column loop's k sequential reductions."""
    G = vectors.gram(X)                       # (k, k) = X^H X
    L = jnp.linalg.cholesky(G)                # G = L L^H
    k = G.shape[0]
    eye = jnp.eye(k, dtype=G.dtype)
    # Q = X · L^{-H}: rows Q_i = Σ_j C[j, i] X_j with C = (L^H)^{-1}
    C = jax.scipy.linalg.solve_triangular(L.conj().T, eye, lower=False)
    Q = vectors.linear_combination(X, C)
    return Q, L.conj().T                      # R = L^H (upper triangular)


@jax.jit
def _cholqr2_core(X):
    """Jitted CholeskyQR2 body: both passes, ``R = R2 R1`` and the validity
    residual computed ON DEVICE in one compiled call.

    Returns ``(Q, R, err)`` where ``err`` is a REAL scalar:
    ``||Q^H Q - I||_F`` when every entry of Q and R is finite, ``+inf``
    otherwise.  Everything runs inside one jitted call; the host reads back
    exactly one real scalar.
    """
    Q1, R1 = _cholqr_pass(X)
    Q, R2 = _cholqr_pass(Q1)
    R = jnp.matmul(R2, R1, precision=jax.lax.Precision.HIGHEST)
    G = vectors.gram(Q)
    k = G.shape[0]
    ortho_err = jnp.linalg.norm(G - jnp.eye(k, dtype=G.dtype))
    # (Near-)rank deficiency surfaces as a zero-to-roundoff Cholesky pivot:
    # depending on rounding the triangular solve yields inf/NaN *or* huge
    # finite junk directions, so test finiteness AND the orthonormality
    # residual itself (one extra k x k Gram).
    finite = jnp.all(jnp.isfinite(R))
    for leaf in jax.tree_util.tree_leaves(Q):
        finite = finite & jnp.all(jnp.isfinite(leaf))
    err = jnp.where(finite, jnp.real(ortho_err),
                    jnp.asarray(jnp.inf, jnp.real(ortho_err).dtype))
    return Q, R, err


def cholesky_qr2(X):
    """CholeskyQR2 factorization of a stacked basis: ``(Q, R, info)``.

    Matmul-based alternative to the column-loop CGS2 :func:`qr` for
    well-conditioned tall-skinny bases (e.g. random initialization,
    Krylov-Schur compression outputs): two Gram-matrix passes restore
    orthonormality to working precision (the "2" in CholeskyQR2) while
    every FLOP is a large batched matmul.  No reference
    counterpart — the reference's only basis QR is the CGS2 loop
    (qr.fypp:116-167).

    ``info = 0`` on success, ``-1`` when the Gram matrix is numerically
    rank-deficient (Cholesky breakdown) or orthonormality was not achieved
    *at the basis dtype's own tolerance* — so an f64/c128 basis whose
    second pass only reached f32-level orthonormality correctly falls back
    to :func:`qr`, whose random-replacement breakdown handling covers that
    case.  The validity check is a single host read of a real scalar
    computed inside jit, so call this from orchestration level, not inside
    jitted loops.
    """
    Q, R, err = _cholqr2_core(X)
    rdt = constants.real_dtype_of(vectors.dtype_of(X))
    ok = bool(jax.device_get(err) < constants.rtol(rdt))
    return Q, R, 0 if ok else -1


def _replacement_basis(key, X):
    """Pre-drawn random candidates, one per column, for breakdown repair."""
    if key is None:
        key = vectors.default_key()
    return vectors.rand_basis(key, X)


@timed_fn("krylov.qr", "BaseKrylov")
def qr(X, tol: float | None = None, key=None):
    """CGS2 QR of the stacked basis ``X`` -> ``(Q, R, info)``.

    ``Q`` has orthonormal columns spanning ``X`` (collinear columns replaced
    by random orthonormalized directions with ``R[j, j] = 0``), ``R`` is
    upper triangular and ``info`` is the 1-based index of the first
    replacement, 0 if none (reference: qr.fypp:116-167).
    """
    k = vectors.basis_size(X)
    dt = vectors.dtype_of(X)
    rdt = constants.real_dtype_of(dt)
    if tol is None:
        tol = constants.atol(rdt)
    repl = _replacement_basis(key, X)

    Q0 = vectors.zero_basis_like(X)
    R0 = jnp.zeros((k, k), dt)
    info0 = jnp.zeros((), jnp.int32)

    def body(j, carry):
        Q, R, info = carry
        xj = vectors.get_column(X, j)
        # project against the j processed columns (cols >= j are zero),
        # streaming only the live chunks (active-prefix CGS2)
        v, proj = double_gram_schmidt_step(xj, Q, k=j)
        beta = vectors.norm(v)
        broke = beta < tol

        # Breakdown: substitute a random direction, re-orthogonalized.  The
        # repair projection is a SECOND full CGS2 pass, so it lives under
        # lax.cond — the HLO conditional executes only the taken branch, so
        # the common no-breakdown path pays one projection per column, not
        # two (reference re-orthogonalizes replacements only on breakdown,
        # qr.fypp:146-160).
        def _repair(_):
            rj = vectors.get_column(repl, j)
            r_orth, _ = double_gram_schmidt_step(rj, Q, k=j)
            rnorm = vectors.norm(r_orth)
            return vectors.scal(
                jnp.where(rnorm > 0, 1.0 / rnorm, 0.0).astype(rdt), r_orth)

        def _keep(_):
            return vectors.scal(
                jnp.where(beta > 0, 1.0 / beta, 0.0).astype(rdt), v)

        v_new = jax.lax.cond(broke, _repair, _keep, None)
        Q = vectors.set_column(Q, j, v_new)
        R = R.at[:, j].set(proj)
        R = R.at[j, j].set(jnp.where(broke, jnp.zeros((), dt), beta.astype(dt)))
        info = jnp.where((info == 0) & broke, j + 1, info)
        # NaN beta is NOT a breakdown — the data is corrupt; record a fatal
        # negative info for check_info (reference: qr.fypp:72-78 stops on
        # isnan(beta)).  `beta < tol` is False for NaN, so without this the
        # NaN would silently propagate.
        info = jnp.where(jnp.isnan(jnp.real(beta)), -(j + 1), info).astype(jnp.int32)
        return Q, R, info

    return jax.lax.fori_loop(0, k, body, (Q0, R0, info0))


@timed_fn("krylov.qr_pivoted", "BaseKrylov")
def qr_pivoted(X, tol: float | None = None, key=None):
    """Rank-revealing CGS2 QR with column pivoting ->
    ``(Q, R, perm, info)`` with ``X[:, perm] = Q R`` in matrix notation,
    ``perm`` 0-based (reference: qr.fypp:32-107,176-202 — running column
    norms ``Rii``, max-pivot selection, column swapping; ``invperm`` is
    ``jnp.argsort(perm)``).

    ``info`` = number of columns replaced after rank exhaustion.
    """
    k = vectors.basis_size(X)
    dt = vectors.dtype_of(X)
    rdt = constants.real_dtype_of(dt)
    if tol is None:
        tol = constants.atol(rdt)
    repl = _replacement_basis(key, X)

    # Work on a mutable copy of the columns; Rii = running squared norms.
    W0 = vectors.copy(X)
    Rii0 = jnp.real(jnp.diagonal(vectors.gram(X))).astype(rdt)
    Q0 = vectors.zero_basis_like(X)
    R0 = jnp.zeros((k, k), dt)
    perm0 = jnp.arange(k, dtype=jnp.int32)
    info0 = jnp.zeros((), jnp.int32)

    def swap_cols(W, R, Rii, perm, i, j):
        """Swap stacked columns i and j of W, the leading rows of R, Rii, perm."""
        def leaf_swap(l):
            li, lj = l[i], l[j]
            return l.at[i].set(lj).at[j].set(li)

        W = jax.tree.map(leaf_swap, W)
        Ri, Rj = R[:, i], R[:, j]
        R = R.at[:, i].set(Rj).at[:, j].set(Ri)
        Rii = Rii.at[i].set(Rii[j]).at[j].set(Rii[i])
        pi, pj = perm[i], perm[j]
        perm = perm.at[i].set(pj).at[j].set(pi)
        return W, R, Rii, perm

    def body(j, carry):
        W, Q, R, Rii, perm, info = carry
        # pivot: column with largest remaining norm among j..k-1
        masked = jnp.where(jnp.arange(k) >= j, Rii, -jnp.inf)
        piv = jnp.argmax(masked).astype(jnp.int32)
        W, R, Rii, perm = swap_cols(W, R, Rii, perm, j, piv)

        wj = vectors.get_column(W, j)
        v, proj = double_gram_schmidt_step(wj, Q, k=j)
        beta = vectors.norm(v)
        broke = beta**2 < tol

        # Repair projection only on the taken branch (see qr() above).
        def _repair(_):
            rj = vectors.get_column(repl, j)
            r_orth, _ = double_gram_schmidt_step(rj, Q, k=j)
            rnorm = vectors.norm(r_orth)
            return vectors.scal(
                jnp.where(rnorm > 0, 1.0 / rnorm, 0.0).astype(rdt), r_orth)

        def _keep(_):
            return vectors.scal(
                jnp.where(beta > 0, 1.0 / beta, 0.0).astype(rdt), v)

        qj = jax.lax.cond(broke, _repair, _keep, None)
        Q = vectors.set_column(Q, j, qj)
        R = R.at[:, j].set(proj)
        R = R.at[j, j].set(jnp.where(broke, jnp.zeros((), dt), beta.astype(dt)))
        # downdate running column norms: |w_i|^2 -= |q_j^H w_i|^2
        coeffs = vectors.innerprod(_as_single(qj), W)[0]
        Rii = Rii - jnp.abs(coeffs) ** 2
        Rii = Rii.at[j].set(-jnp.inf)  # processed
        info = info + jnp.where(broke, 1, 0).astype(jnp.int32)
        # NaN beta is fatal, not rank exhaustion (reference: qr.fypp:139-145)
        info = jnp.where(jnp.isnan(jnp.real(beta)) & (info >= 0),
                         -(j + 1), info).astype(jnp.int32)
        return W, Q, R, Rii, perm, info

    W, Q, R, Rii, perm, info = jax.lax.fori_loop(
        0, k, body, (W0, Q0, R0, Rii0, perm0, info0)
    )
    return Q, R, perm, info


def _as_single(v):
    """Lift a vector into a 1-column stacked basis."""
    return jax.tree.map(lambda l: l[None], v)
