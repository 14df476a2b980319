"""On-device real-Hessenberg eigensolve (jitted Francis double-shift QR).

The projected k x k problem in ``eigs`` is non-Hermitian; XLA has no
on-device GEEV, so a host round trip per convergence check was the one
remaining off-device step of the eigs inner loop (SURVEY.md §7 lists
on-device non-Hermitian dense work as the acknowledged hard part).  This
module removes it for *real* Hessenberg matrices — the common case: every
real-operator eigenproblem, including realified complex ones
(reference call site: ``eig`` of ``H(:k,:k)`` each Arnoldi step,
src/IterativeSolvers/IterativeSolvers.fypp:1065; LAPACK-convention ``eig``
wrapper at src/Utilities/Utils.fypp:128-165).

Structure mirrors LAPACK's own split, re-expressed as fixed-shape jitted
loops (no data-dependent Python control flow):

- :func:`hessenberg_eigvals` — ``dhseqr``-style eigenvalues-only Francis
  double-shift QR with deflation, 2x2-block acceptance, and exceptional
  shifts.  All arithmetic is REAL (complex pairs live in accepted 2x2
  diagonal blocks) — nothing here requires a complex dtype.
- :func:`hessenberg_eigvecs` — ``dhsein``-style eigenvectors by one step of
  inverse iteration: for each eigenvalue the realified ``2n x 2n`` system
  ``[[H - wr I, wi I], [-wi I, H - wr I]]`` is solved against a fixed
  right-hand side (batched LU over all eigenvalues at once).
- :func:`hessenberg_ritz` — the fused driver product: eigenvalues, Ritz
  residuals ``|beta| * |last eigvec component|`` (reference:
  IterativeSolvers.fypp:1069-1083), modulus-descending order and the
  device-side converged count, from the *extended* Hessenberg buffer with a
  dynamic active size ``k_eff`` (one compilation serves every sweep).

The active problem is embedded in the static ``(n, n)`` buffer by zeroing
the inactive block and planting well-separated dummy diagonal entries
(magnitude ``> 2 ||H||``) — already-deflated 1x1 blocks the QR iteration
never touches, masked out of residuals/ordering afterwards.
"""

from __future__ import annotations

from functools import partial, wraps

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["francis_filter", "hessenberg_eigvals", "hessenberg_eigvecs",
           "hessenberg_ritz", "ordschur_device", "schur_real"]


def _full_precision(fn):
    """Trace the wrapped body under full-f32 matmul precision.

    A default-precision f32 matmul may round to TF32 on a GPU; an
    iterative similarity transform (hundreds of Householder/Givens
    applications) amplifies reduced-precision products into O(1) spectral
    error AND stalls deflation.  The matmuls here are all small (3 x n);
    full f32 precision is free."""

    @wraps(fn)
    def wrapped(*a, **k):
        with jax.default_matmul_precision("float32"):
            return fn(*a, **k)

    return wrapped


def _householder3(x, y, z):
    """3-element Householder ``P = I - 2 v v^T / (v^T v)`` annihilating
    ``(y, z)`` in ``(x, y, z)``; identity when the vector already is
    ``(x, 0, 0)`` (guarded divisions — this runs masked inside the chase)."""
    dt = x.dtype
    s = jnp.sqrt(x * x + y * y + z * z)
    alpha = -jnp.where(x >= 0, s, -s)
    v0 = x - alpha
    vnorm2 = v0 * v0 + y * y + z * z
    safe = vnorm2 > 0
    inv = jnp.where(safe, 2.0 / jnp.where(safe, vnorm2, 1.0), 0.0)
    v = jnp.stack([v0, y, z])
    P = jnp.eye(3, dtype=dt) - inv * jnp.outer(v, v)
    return P


def _chase(H, lo, hi, s, t, Z=None):
    """One Francis double-implicit-shift bulge chase on window ``[lo, hi]``
    (0-indexed, inclusive; size >= 3) with shift sum ``s`` / product ``t``
    (Golub & Van Loan Alg. 7.5.1-7.5.2).  ``lo``/``hi`` are traced scalars;
    the chase runs over the full static position range, masked to the
    window.  Row/column updates apply to full slices — entries outside the
    window in the touched rows/cols are exactly zero by the Hessenberg +
    deflation structure, so full-slice application is the correct global
    similarity.

    With ``Z`` (an ``n x n`` matrix), the accumulated right transform is
    also returned (``Z <- Z Q`` for ``H <- Q^T H Q``) — needed by the
    IRAM filter restart, which compresses the Krylov basis with ``Z``.
    Returns ``H`` alone when ``Z is None``, else ``(H, Z)``."""
    n = H.shape[0]
    with_z = Z is not None
    if n < 3:  # a size-3 window cannot exist; branch is traced regardless
        return (H, Z) if with_z else H
    if not with_z:
        Z = jnp.zeros((0, n), H.dtype)  # static empty: updates are no-ops

    def cond(c):
        # exactly the active positions [lo, hi-2] — no masked iterations
        # (a fori over the full static range with a lax.cond per position
        # wastes most steps once deflation shrinks the windows)
        return c[2] <= hi - 2

    def step(c):
        H, Z, p = c
        # first position: implicit first column of (H - aI)(H - bI) e1;
        # later positions: the bulge column p-1
        h00 = H[lo, lo]
        h01 = H[lo, lo + 1]
        h10 = H[lo + 1, lo]
        h11 = H[lo + 1, lo + 1]
        h21 = H[lo + 2, lo + 1]
        x0 = h00 * h00 + h01 * h10 - s * h00 + t
        y0 = h10 * (h00 + h11 - s)
        z0 = h10 * h21
        pm1 = jnp.maximum(p - 1, 0)
        first = p == lo
        x = jnp.where(first, x0, H[p, pm1])
        y = jnp.where(first, y0, H[p + 1, pm1])
        z = jnp.where(first, z0, H[p + 2, pm1])
        P = _householder3(x, y, z)
        rows = jax.lax.dynamic_slice(H, (p, jnp.int32(0)), (3, n))
        H2 = jax.lax.dynamic_update_slice(H, P @ rows, (p, jnp.int32(0)))
        cols = jax.lax.dynamic_slice(H2, (jnp.int32(0), p), (n, 3))
        H2 = jax.lax.dynamic_update_slice(H2, cols @ P, (jnp.int32(0), p))
        zc = jax.lax.dynamic_slice(Z, (jnp.int32(0), p),
                                   (Z.shape[0], 3))
        Z2 = jax.lax.dynamic_update_slice(Z, zc @ P, (jnp.int32(0), p))
        # annihilated bulge entries: exactly zero (standard practice —
        # roundoff residue here would masquerade as a coupling)
        H2 = jnp.where(first, H2,
                       H2.at[p + 1, pm1].set(0.0).at[p + 2, pm1].set(0.0))
        return H2, Z2, p + 1

    # clamp the bulge position so the (3, n) slices stay in range even if
    # a caller passes a degenerate window
    p0 = jnp.clip(jnp.asarray(lo, jnp.int32), 0, n - 3)
    H, Z, _ = jax.lax.while_loop(cond, step, (H, Z, p0))

    # final Givens on rows/cols (hi-1, hi) zeroing H[hi, hi-2]
    x = H[hi - 1, hi - 2]
    y = H[hi, hi - 2]
    r = jnp.sqrt(x * x + y * y)
    safe = r > 0
    c = jnp.where(safe, x / jnp.where(safe, r, 1.0), 1.0)
    sn = jnp.where(safe, y / jnp.where(safe, r, 1.0), 0.0)
    G = jnp.stack([jnp.stack([c, sn]), jnp.stack([-sn, c])])
    rows = jax.lax.dynamic_slice(H, (hi - 1, jnp.int32(0)), (2, n))
    H = jax.lax.dynamic_update_slice(H, G @ rows, (hi - 1, jnp.int32(0)))
    cols = jax.lax.dynamic_slice(H, (jnp.int32(0), hi - 1), (n, 2))
    H = jax.lax.dynamic_update_slice(H, cols @ G.T, (jnp.int32(0), hi - 1))
    zc = jax.lax.dynamic_slice(Z, (jnp.int32(0), hi - 1), (Z.shape[0], 2))
    Z = jax.lax.dynamic_update_slice(Z, zc @ G.T, (jnp.int32(0), hi - 1))
    H = H.at[hi, hi - 2].set(0.0)
    return (H, Z) if with_z else H


def _embed(H, k_eff):
    """Zero the inactive block of the static buffer and plant separated
    dummy diagonal entries there (pre-deflated 1x1 blocks)."""
    n = H.shape[0]
    idx = jnp.arange(n)
    active = idx < k_eff
    Hm = jnp.where(active[:, None] & active[None, :], H, 0.0)
    norm = jnp.max(jnp.abs(Hm)) + 1.0
    dummy = norm * (2.0 + idx.astype(H.dtype) / n)
    diag = jnp.where(active, jnp.diagonal(Hm), dummy)
    return Hm.at[idx, idx].set(diag), active


def _to_hessenberg(H, Z=None):
    """Householder similarity reduction to upper Hessenberg form (GEHRD
    analogue), fully vectorized per column.

    Needed because the projected matrix is only Hessenberg on the FIRST
    sweep — after a Krylov-Schur restart it is quasi-triangular with a full
    ``b`` row appended (the Krylov-Schur form, BaseKrylov.fypp:782-834),
    which the Francis chase's structural assumptions do not cover.
    Similarity only for the eigensolve path — eigenvectors are later
    computed from the *original* matrix by inverse iteration, so no
    back-transform is required there.  With ``Z``, the accumulated right
    transform is also returned (``(H, Z)``), for callers that transform a
    basis (the IRAM filter restart)."""
    n = H.shape[0]
    with_z = Z is not None
    if n < 3:
        return (H, Z) if with_z else H
    dt = H.dtype
    rows = jnp.arange(n)
    if not with_z:
        Z = jnp.zeros((0, n), dt)  # static empty: updates are no-ops

    def step(j, HZ):
        H, Z = HZ
        col = H[:, j]
        below = rows > j
        x = jnp.where(below, col, 0.0)
        s = jnp.sqrt(jnp.sum(x * x))
        x0 = H[j + 1, j]
        alpha = -jnp.where(x0 >= 0, s, -s)
        u = x - alpha * (rows == j + 1).astype(dt)
        un2 = jnp.sum(u * u)
        safe = un2 > 0
        inv = jnp.where(safe, 2.0 / jnp.where(safe, un2, 1.0), 0.0)
        H = H - inv * jnp.outer(u, u @ H)
        H = H - inv * jnp.outer(H @ u, u)
        Z = Z - inv * jnp.outer(Z @ u, u)
        # annihilated entries: exactly zero (roundoff residue would read
        # as couplings downstream)
        keep = ~below | (rows == j + 1)
        H = H.at[:, j].set(jnp.where(keep, H[:, j], 0.0))
        return H, Z

    H, Z = jax.lax.fori_loop(0, n - 2, step, (H, Z))
    return (H, Z) if with_z else H


def _schur_core(H, Z=None):
    """Iterate Francis sweeps to quasi-triangular form.  Returns
    ``(H, Z, accepted, ok)`` — ``accepted[i]`` marks a terminal 2x2 diagonal
    block coupling rows ``(i, i+1)``; ``ok`` is False only if the sweep
    budget (30 n, LAPACK's) ran out.  ``Z`` (optional ``m x n``) accumulates
    the right transform across every chase (``H_out = Q^T H_in Q``,
    ``Z <- Z Q``) — needed by the on-device Schur/ordschur path; passing
    ``None`` threads a static-empty matrix whose updates are no-ops."""
    n = H.shape[0]
    dt = H.dtype
    if Z is None:
        Z = jnp.zeros((0, n), dt)
    if n < 2:  # already triangular
        return H, Z, jnp.zeros((0,), bool), jnp.asarray(True)
    eps = jnp.asarray(np.finfo(np.dtype(dt)).eps, dt)
    ii = jnp.arange(n - 1, dtype=jnp.int32)
    max_sweeps = 30 * n

    def deflate(H):
        d = jnp.abs(jnp.diagonal(H))
        sub = H[ii + 1, ii]
        # LAPACK dlahqr-style test, with the zero-diagonal safeguard (a
        # zero neighbour-sum must not make the threshold vanish)
        tst = d[:-1] + d[1:]
        tst = jnp.where(tst == 0, jnp.max(jnp.abs(H)), tst)
        small = jnp.abs(sub) <= eps * tst
        return H.at[ii + 1, ii].set(jnp.where(small, 0.0, sub))

    def open_mask(H, accepted):
        return (H[ii + 1, ii] != 0) & ~accepted

    def cond(carry):
        H, Z, accepted, last_hi, stall, sweeps = carry
        return jnp.any(open_mask(H, accepted)) & (sweeps < max_sweeps)

    def body(carry):
        H, Z, accepted, last_hi, stall, sweeps = carry
        H = deflate(H)
        op = open_mask(H, accepted)
        any_open = jnp.any(op)
        # bottom of the active window: largest open coupling
        hi_c = jnp.max(jnp.where(op, ii, jnp.int32(-1)))
        hi = (hi_c + 1).astype(jnp.int32)
        # top: just below the nearest zero coupling above
        zero_below = (H[ii + 1, ii] == 0) & (ii < hi_c)
        lo = jnp.max(jnp.where(zero_below, ii + 1, 0))
        stall = jnp.where(hi == last_hi, stall + 1, 0)

        def accept(HZa):
            H, Z, accepted = HZa
            return H, Z, accepted.at[jnp.maximum(hi_c, 0)].set(True)

        def sweep(HZa):
            H, Z, accepted = HZa
            # trailing 2x2 Wilkinson double shift; exceptional every 10
            # stalled sweeps (LAPACK dlahqr-style backstop)
            a11 = H[hi - 1, hi - 1]
            a12 = H[hi - 1, hi]
            a21 = H[hi, hi - 1]
            a22 = H[hi, hi]
            s = a11 + a22
            t = a11 * a22 - a12 * a21
            exc = (stall > 0) & (stall % 10 == 0)
            sexc = jnp.abs(a21) + jnp.abs(H[hi - 1, jnp.maximum(hi - 2, 0)])
            wexc = a22 + 0.75 * sexc
            s = jnp.where(exc, 2.0 * wexc, s)
            t = jnp.where(exc, wexc * wexc, t)
            H, Z = _chase(H, lo, hi, s, t, Z=Z)
            return H, Z, accepted

        H, Z, accepted = jax.lax.cond(
            any_open & (hi - lo >= 2), sweep,
            lambda HZa: jax.lax.cond(any_open, accept,
                                     lambda hza: hza, HZa),
            (H, Z, accepted))
        return H, Z, accepted, hi, stall, sweeps + 1

    accepted0 = jnp.zeros(max(n - 1, 1), bool)[: n - 1]
    H, Z, accepted, _, _, sweeps = jax.lax.while_loop(
        cond, body,
        (H, Z, accepted0, jnp.int32(-1), jnp.int32(0), jnp.int32(0)))
    ok = ~jnp.any(open_mask(H, accepted))
    return H, Z, accepted, ok


def _extract_eigvals(H, accepted):
    """Eigenvalues from the quasi-triangular form: diagonal entries for 1x1
    blocks, quadratic formula on accepted 2x2 blocks (complex pairs carried
    as separate real/imag arrays — no complex dtype)."""
    n = H.shape[0]
    d = jnp.diagonal(H)
    pad = jnp.zeros((1,), H.dtype)
    pair_start = jnp.concatenate([accepted, pad.astype(bool)])
    pair_second = jnp.concatenate([pad.astype(bool), accepted])
    a = d
    b = jnp.concatenate([jnp.diagonal(H, 1), pad])   # H[i, i+1]
    c = jnp.concatenate([jnp.diagonal(H, -1), pad])  # H[i+1, i]
    dd = jnp.concatenate([d[1:], pad])               # H[i+1, i+1]
    m = 0.5 * (a + dd)
    disc = 0.25 * (a - dd) ** 2 + b * c
    sq = jnp.sqrt(jnp.abs(disc))
    real_pair = disc >= 0
    wr1 = jnp.where(real_pair, m + sq, m)
    wr2 = jnp.where(real_pair, m - sq, m)
    wi1 = jnp.where(real_pair, 0.0, sq)
    # assign: pair start gets (wr1, +wi1); the row below gets (wr2, -wi1)
    wr2s = jnp.concatenate([pad, wr2[:-1]])
    wi2s = jnp.concatenate([pad, wi1[:-1]])
    wr = jnp.where(pair_start, wr1, jnp.where(pair_second, wr2s, d))
    wi = jnp.where(pair_start, wi1, jnp.where(pair_second, -wi2s, 0.0))
    return wr, wi


@partial(jax.jit, static_argnames=())
@_full_precision
def hessenberg_eigvals(H, k_eff=None):
    """Eigenvalues of a real upper-Hessenberg matrix, fully on device.

    Returns ``(wr, wi, ok)``: real/imag parts (position-aligned with the
    buffer; entries at index ``>= k_eff`` are inactive dummies reported as
    ``0``) and a convergence flag.  ``k_eff`` may be a traced scalar; it
    defaults to the full buffer.
    """
    H = jnp.asarray(H)
    if jnp.issubdtype(H.dtype, jnp.complexfloating):
        raise TypeError("hessenberg_eigvals is real-only; complex projected "
                        "problems take the host LAPACK path")
    n = H.shape[0]
    k_eff = jnp.asarray(n if k_eff is None else k_eff, jnp.int32)
    Hm, active = _embed(H, k_eff)
    Hm = _to_hessenberg(Hm)
    T, _, accepted, ok = _schur_core(Hm)
    wr, wi = _extract_eigvals(T, accepted)
    wr = jnp.where(active, wr, 0.0)
    wi = jnp.where(active, wi, 0.0)
    return wr, wi, ok


def _split_real_blocks(T, Z, accepted):
    """Split accepted 2x2 diagonal blocks whose eigenvalues are REAL into
    two 1x1 blocks by a Givens similarity (the standardization role of
    LAPACK ``dlanv2`` inside dhseqr): after this pass every remaining 2x2
    block is a genuine complex-conjugate pair.  Required by the ordschur
    path — a selector must be able to separate two real eigenvalues that
    the QR iteration happened to leave sharing a block.

    The rotation's first column is the (normalized) eigenvector of the
    larger-modulus real eigenvalue ``lam``: ``G^T A G e1 = lam e1`` makes
    the block upper triangular with ``lam`` leading."""
    n = T.shape[0]
    if n < 2:
        return T, Z, accepted
    dt = T.dtype
    z0 = jnp.int32(0)

    def step(i, TZa):
        i = jnp.asarray(i, jnp.int32)
        T, Z, acc = TZa
        a, b = T[i, i], T[i, i + 1]
        c, d = T[i + 1, i], T[i + 1, i + 1]
        m = 0.5 * (a + d)
        disc = 0.25 * (a - d) ** 2 + b * c
        do = acc[i] & (disc >= 0)
        sq = jnp.sqrt(jnp.abs(disc))
        lam = m + jnp.where(m >= 0, sq, -sq)
        # eigenvector of the 2x2 block for lam: both analytic forms are
        # exact null vectors of (A - lam I); take the larger for stability
        # (at least one is nonzero whenever the block is non-scalar)
        v1 = jnp.stack([b, lam - a])
        v2 = jnp.stack([lam - d, c])
        v = jnp.where(jnp.sum(v1 * v1) >= jnp.sum(v2 * v2), v1, v2)
        nrm = jnp.sqrt(jnp.sum(v * v))
        safe = nrm > 0
        v = jnp.where(safe, v / jnp.where(safe, nrm, 1.0),
                      jnp.asarray([1.0, 0.0], dt))
        G = jnp.stack([v, jnp.stack([-v[1], v[0]])], axis=1)
        G = jnp.where(do, G, jnp.eye(2, dtype=dt))
        rows = jax.lax.dynamic_slice(T, (i, z0), (2, n))
        T = jax.lax.dynamic_update_slice(T, G.T @ rows, (i, z0))
        cols = jax.lax.dynamic_slice(T, (z0, i), (n, 2))
        T = jax.lax.dynamic_update_slice(T, cols @ G, (z0, i))
        zc = jax.lax.dynamic_slice(Z, (z0, i), (Z.shape[0], 2))
        Z = jax.lax.dynamic_update_slice(Z, zc @ G, (z0, i))
        T = T.at[i + 1, i].set(jnp.where(do, 0.0, T[i + 1, i]))
        acc = acc.at[i].set(jnp.where(do, False, acc[i]))
        return T, Z, acc

    return jax.lax.fori_loop(0, n - 1, step, (T, Z, accepted))


@partial(jax.jit, static_argnames=())
@_full_precision
def schur_real(H, k_eff=None):
    """Real Schur decomposition ``H = Z T Z^T`` fully on device: Householder
    Hessenberg reduction + Francis QR with accumulated transforms + real-pair
    block standardization.  Device-mode counterpart of the host LAPACK
    ``schur`` used by the Krylov-Schur restart (reference: stdlib ``schur``,
    BaseKrylov.fypp:807).

    Returns ``(T, Z, wr, wi, ok)``: ``T`` quasi-triangular (every 2x2 block
    a complex-conjugate pair), ``Z`` orthogonal, ``(wr, wi)`` the
    eigenvalues aligned with ``T``'s diagonal positions, ``ok`` the sweep
    convergence flag.  With ``k_eff``, the active block is embedded as in
    :func:`hessenberg_eigvals` (``Z`` is then identity on the inactive
    part and the factorization holds for the embedded matrix).
    """
    H = jnp.asarray(H)
    if jnp.issubdtype(H.dtype, jnp.complexfloating):
        raise TypeError("schur_real is real-only; complex projected "
                        "problems take the host LAPACK path")
    n = H.shape[0]
    k_eff = jnp.asarray(n if k_eff is None else k_eff, jnp.int32)
    Hm, active = _embed(H, k_eff)
    Z0 = jnp.eye(n, dtype=H.dtype)
    Hh, Z = _to_hessenberg(Hm, Z0)
    T, Z, accepted, ok = _schur_core(Hh, Z)
    T, Z, accepted = _split_real_blocks(T, Z, accepted)
    wr, wi = _extract_eigvals(T, accepted)
    wr = jnp.where(active, wr, 0.0)
    wi = jnp.where(active, wi, 0.0)
    return T, Z, wr, wi, ok


def _swap_q_factory(n1, n2, dt):
    """Direct-swap orthogonal transform for adjacent diagonal blocks of
    static sizes ``(n1, n2)`` (Bai & Demmel's method, LAPACK ``dlaexc``):
    solve the tiny Sylvester equation ``A11 X - X A22 = -A12``, then QR
    ``[X; I]`` to get the orthogonal ``Q`` whose leading ``n2`` columns
    span the A22-invariant subspace — ``Q^T W Q`` has the A22 block
    leading.  Returns a 4x4 matrix (identity beyond ``n1+n2``) so callers
    can apply one fixed-shape window update regardless of block sizes."""
    m = n1 + n2
    eps = np.finfo(np.dtype(dt)).eps

    def f(W):
        A11 = W[:n1, :n1]
        A12 = W[:n1, n1:m]
        A22 = W[n1:m, n1:m]
        K = (jnp.kron(jnp.eye(n2, dtype=dt), A11)
             - jnp.kron(A22.T, jnp.eye(n1, dtype=dt)))
        rhs = -A12.T.reshape(-1)  # column-major vec
        # K is singular iff the blocks share an eigenvalue — the swap is
        # then ill-defined; the tiny ridge keeps the solve finite and the
        # caller's residual test rejects the resulting bad swap.
        reg = eps * (jnp.max(jnp.abs(K)) + 1.0)
        x = jnp.linalg.solve(K + reg * jnp.eye(n1 * n2, dtype=dt), rhs)
        X = x.reshape(n2, n1).T
        M = jnp.concatenate([X, jnp.eye(n2, dtype=dt)], axis=0)
        Q, _ = jnp.linalg.qr(M, mode="complete")
        Qf = jnp.eye(4, dtype=dt)
        return Qf.at[:m, :m].set(Q)

    return f


def _ordschur_core(T, Z, sel, rej_factor=50.0):
    """Reorder a real Schur form so the ``sel``-flagged diagonal positions
    occupy the leading block — LAPACK TRSEN/dtrexc's method (bubble the
    selected blocks upward by adjacent orthogonal block swaps) as one
    jitted fixed-shape while_loop.

    ``sel`` must be pair-consistent (both positions of a 2x2 block equal);
    2x2 blocks must be complex-conjugate pairs (``_split_real_blocks``).
    A swap whose annihilated coupling exceeds ``rej_factor * eps * ||T||``
    is rejected and the loop stops (``ok = False``); everything applied up
    to that point is still an exact orthogonal similarity, so the output
    remains a valid (partially reordered) Schur factorization.
    """
    n = T.shape[0]
    dt = T.dtype
    eps = np.finfo(np.dtype(dt)).eps
    z0 = jnp.int32(0)
    P = n + 3  # pad so every 4x4 window slice stays in range
    Tp = jnp.zeros((P, P), dt).at[:n, :n].set(T)
    Zp = jnp.zeros((Z.shape[0], P), dt).at[:, :n].set(Z)
    idx = jnp.arange(n, dtype=jnp.int32)
    fns = [_swap_q_factory(a, b, dt)
           for a in (1, 2) for b in (1, 2)]  # index (n1-1)*2 + (n2-1)
    max_swaps = n * n + 4

    def find(Tp, sel):
        # first block start whose block is unselected with a selected
        # block directly below it (the bubble-sort move); n = none
        sub = Tp[idx + 1, idx]
        prev = jnp.concatenate([jnp.zeros(1, dt), sub[:-1]])
        start = (idx == 0) | (prev == 0)
        nxt = idx + 1 + (sub != 0)
        cand = (start & (nxt < n) & ~sel
                & sel[jnp.clip(nxt, 0, n - 1)])
        return jnp.min(jnp.where(cand, idx, jnp.int32(n)))

    def cond(c):
        Tp, Zp, sel, failed, cnt = c
        return (find(Tp, sel) < n) & ~failed & (cnt < max_swaps)

    def body(c):
        Tp, Zp, sel, failed, cnt = c
        i = jnp.clip(find(Tp, sel), 0, n - 1)
        n1 = 1 + (Tp[i + 1, i] != 0).astype(jnp.int32)
        j = jnp.clip(i + n1, 0, n - 1)
        n2 = 1 + (Tp[j + 1, j] != 0).astype(jnp.int32)
        m = n1 + n2
        W = jax.lax.dynamic_slice(Tp, (i, i), (4, 4))
        Q = jax.lax.switch((n1 - 1) * 2 + (n2 - 1), fns, W)
        # pre-apply on the window alone to test the swap before committing
        Wt = Q.T @ W @ Q
        r4 = jnp.arange(4)
        lowleft = ((r4[:, None] >= n2) & (r4[:, None] < m)
                   & (r4[None, :] < n2))
        resid = jnp.max(jnp.where(lowleft, jnp.abs(Wt), 0.0))
        bad = resid > rej_factor * eps * (jnp.max(jnp.abs(Tp)) + 1.0)

        def apply(args):
            Tp, Zp, sel = args
            rows = jax.lax.dynamic_slice(Tp, (i, z0), (4, P))
            Tp = jax.lax.dynamic_update_slice(Tp, Q.T @ rows, (i, z0))
            cols = jax.lax.dynamic_slice(Tp, (z0, i), (P, 4))
            Tp = jax.lax.dynamic_update_slice(Tp, cols @ Q, (z0, i))
            zc = jax.lax.dynamic_slice(Zp, (z0, i), (Zp.shape[0], 4))
            Zp = jax.lax.dynamic_update_slice(Zp, zc @ Q, (z0, i))
            # exact zeros below the new block diagonal inside the window
            # (keep only the 2x2-internal couplings of the new layout:
            # block of size n2 leads, block of size n1 follows)
            for r in range(1, 4):
                for cc in range(r):
                    keep = (((n2 == 2) & (r == 1) & (cc == 0))
                            | ((n1 == 2) & (r == n2 + 1) & (cc == n2)))
                    zero_it = (r < m) & ~keep
                    Tp = Tp.at[i + r, i + cc].set(
                        jnp.where(zero_it, 0.0, Tp[i + r, i + cc]))
            # the selected block now leads the window; flags move with it
            selP = jnp.where((idx >= i) & (idx < i + m), idx < i + n2, sel)
            return Tp, Zp, selP

        Tp, Zp, sel = jax.lax.cond(~bad, apply, lambda a: a, (Tp, Zp, sel))
        return Tp, Zp, sel, failed | bad, cnt + 1

    Tp, Zp, sel, failed, cnt = jax.lax.while_loop(
        cond, body, (Tp, Zp, sel, jnp.asarray(False), jnp.int32(0)))
    done = find(Tp, sel) >= n
    return Tp[:n, :n], Zp[:, :n], sel, done & ~failed


@partial(jax.jit, static_argnames=())
@_full_precision
def ordschur_device(T, Z, select_mask):
    """Device-mode ordschur — reorder the real Schur factorization
    ``(T, Z)`` so the eigenvalues at the ``select_mask``-flagged diagonal
    positions occupy the leading block (reference: ``ordschur``/TRSEN,
    Utils.fypp:37-60, used by ``krylov_schur``, BaseKrylov.fypp:813).

    ``select_mask`` is per diagonal position of ``T``; it is made
    pair-consistent here (a flag on either position of a 2x2 block selects
    the whole block, matching LAPACK's behavior).  Returns
    ``(T', Z', sel', ok)`` where ``sel'`` is the reordered mask (leading
    ``sum(sel')`` positions True on success) and ``ok`` is False if a
    block swap was rejected (near-coincident eigenvalues across the swap —
    the output is then a valid but only partially reordered form).
    """
    T = jnp.asarray(T)
    Z = jnp.asarray(Z)
    n = T.shape[0]
    sel = jnp.asarray(select_mask, bool)
    if n < 2:
        return T, Z, sel, jnp.asarray(True)
    sub = T[jnp.arange(n - 1) + 1, jnp.arange(n - 1)]
    coupled = sub != 0
    pad = jnp.zeros(1, bool)
    up = jnp.concatenate([coupled & sel[1:], pad])
    down = jnp.concatenate([pad, coupled & sel[:-1]])
    sel = sel | up | down
    return _ordschur_core(T, Z, sel)


@partial(jax.jit, static_argnames=())
@_full_precision
def francis_filter(H_sq, n_target):
    """Exact-shift IRAM filter for a Krylov restart, fully on device.

    Applies ``(kdim - n) / 2`` Francis double-shift sweeps to the square
    Hessenberg ``H_sq``, with the shifts taken pairwise from the
    smallest-modulus eigenvalues (the unwanted part of the spectrum —
    equivalent in intent to the reference's median-of-|lambda| Krylov-Schur
    selector, IterativeSolvers.fypp:1099-1100,1137-1142, but via the
    implicitly-restarted-Arnoldi filter-polynomial route, which needs no
    Schur reordering and keeps ``H`` purely Hessenberg).  ``n_target`` may
    be traced; it is adjusted so no complex-conjugate pair straddles the
    kept/unwanted boundary and so the unwanted count is even, then clamped
    to ``[1, kdim - 2]``.

    Returns ``(Hf, Z, n, ok)``: the filtered Hessenberg, the accumulated
    orthogonal transform (``Hf = Z^T H Z``), the adjusted keep count, and
    the eigensolve convergence flag.  The caller compresses the basis with
    ``Z[:, :n]`` and forms the new residual from column ``n`` of ``Z`` and
    the old residual vector (the standard IRAM update).
    """
    kdim = H_sq.shape[0]
    dt = H_sq.dtype
    Zh = jnp.eye(kdim, dtype=dt)
    # STRICT Hessenberg contract: the single-residual IRAM truncation
    # needs e_k^T Z supported on the last p+1 columns, which holds only
    # when every applied transform is a (banded) chase on a Hessenberg
    # matrix.  Reducing an ARROW input (host Krylov-Schur form) first
    # would densify Z's last row and silently break the truncated
    # factorization — on arrow input we apply NO sweeps (a pure
    # truncation of the factorization, which is always exact) and report
    # ``ok = False`` so the caller can filter another way.
    hess_in = jnp.all(jnp.abs(jnp.tril(H_sq, -2)) == 0)
    wr, wi, ok = hessenberg_eigvals(H_sq)
    mod = wr * wr + wi * wi
    # Descending modulus with ties broken by the PAIR's base index: both
    # members of a conjugate pair share every sort key (mod is bitwise
    # identical for +/-wi; pairbase too — _extract_eigvals emits +wi at
    # the pair start and -wi immediately below it), so the stable lexsort
    # keeps each pair adjacent even when two distinct pairs coincide in
    # (modulus, wr) to working precision.  Value-only keys interleave
    # such duplicates as (-s, -s, +s, +s), pairing two non-conjugate
    # eigenvalues into an inexact double shift whose pair then fails to
    # deflate.  The -wi key orders +wi first
    # within each pair.
    idx_k = jnp.arange(kdim, dtype=jnp.int32)
    pairbase = idx_k - (wi < 0)
    order = jnp.lexsort((-wi, pairbase, -mod))

    def straddles(n):
        # does the kept/unwanted boundary split a conjugate pair?
        a = order[jnp.clip(n - 1, 0, kdim - 1)]
        b = order[jnp.clip(n, 0, kdim - 1)]
        return (wi[a] != 0) & (wr[a] == wr[b]) & (wi[a] == -wi[b])

    # adjust n to a FIXED POINT: each +1 can create a new straddle or odd
    # parity at the boundary (the one-shot check let a pair straddle and
    # produced a mixed — hence inexact — shift pair, whose failed
    # deflation filled the sub-Hessenberg and broke the truncation)
    def adj_cond(n):
        odd = (kdim - n) % 2 == 1
        return (straddles(n) | odd) & (n < kdim - 2)

    n = jax.lax.while_loop(adj_cond, lambda n: n + 1,
                           jnp.asarray(n_target, jnp.int32))
    n = jnp.clip(n, 1, kdim - 2).astype(jnp.int32)
    # apply NO shifts (exact pure truncation) on an unresolvable straddle
    # at the clamp (pathological) or a non-Hessenberg (arrow) input
    pure = ~straddles(n) & hess_in

    # shift application order: complex pairs first, then reals — EVERY
    # consecutive pair is then a true conjugate pair or two reals, so all
    # shifts are exact eigenvalues and each sweep genuinely deflates its
    # pair at the window bottom (mandatory: chasing past an un-deflated
    # coupling fills the sub-Hessenberg and invalidates the truncation)
    rank = jnp.zeros(kdim, jnp.int32).at[order].set(
        jnp.arange(kdim, dtype=jnp.int32))
    is_real = (wi == 0)
    key = jnp.where(rank >= n,
                    is_real.astype(jnp.int32) * kdim + rank,
                    3 * kdim + rank)  # wanted pushed past every unwanted
    shift_order = jnp.argsort(key)

    eps = jnp.asarray(np.finfo(np.dtype(dt)).eps, dt)
    ii = jnp.arange(kdim - 1, dtype=jnp.int32)

    def sweep(j, HZ):
        Hc, Zc = HZ
        # explicit deflation (dlahqr-style threshold), then chase ONLY the
        # top-connected block: each exact double shift deflates its pair
        # at the window bottom, and the next sweep must stop at the first
        # LIVE coupling boundary.  Chasing past an un-deflated coupling
        # (the blind shrink-by-2 did, whenever f32 shift error ~ kappa*eps
        # left a pair un-deflated on a non-normal spectrum) fills the
        # sub-Hessenberg and silently corrupts the truncation — caught by
        # the GL flagship's kappa-budget anchors.
        d = jnp.abs(jnp.diagonal(Hc))
        sub = Hc[ii + 1, ii]
        tst = d[:-1] + d[1:]
        tst = jnp.where(tst == 0, jnp.max(jnp.abs(Hc)), tst)
        sub = jnp.where(jnp.abs(sub) <= eps * tst, 0.0, sub)
        Hc = Hc.at[ii + 1, ii].set(sub)
        hi = jnp.min(jnp.where(sub == 0, ii, jnp.int32(kdim - 1)))
        active = ((2 * j + 1) < (kdim - n)) & pure & (hi >= 2)
        ia = shift_order[jnp.clip(2 * j, 0, kdim - 1)]
        ib = shift_order[jnp.clip(2 * j + 1, 0, kdim - 1)]
        s = wr[ia] + wr[ib]
        t = wr[ia] * wr[ib] - wi[ia] * wi[ib]
        return jax.lax.cond(
            active,
            lambda hz: _chase(hz[0], jnp.int32(0), hi, s, t, Z=hz[1]),
            lambda hz: hz, (Hc, Zc))

    Hf, Z = jax.lax.fori_loop(0, kdim // 2, sweep, (H_sq, Zh))
    return Hf, Z, n, ok & pure


def _eigvec_rhs(n, dt):
    """Fixed deterministic right-hand side for inverse iteration (dhsein
    uses a unit vector; a dense incommensurate pattern avoids accidental
    orthogonality to the null direction)."""
    i = jnp.arange(2 * n, dtype=dt)
    b = jnp.sin(1.7 * i + 0.3) + 0.25
    return b / jnp.linalg.norm(b)


@partial(jax.jit, static_argnames=())
@_full_precision
def hessenberg_eigvecs(H, wr, wi, k_eff=None):
    """Eigenvectors by one inverse-iteration solve per eigenvalue
    (LAPACK ``dhsein``'s method), batched over all eigenvalues.

    For eigenvalue ``wr[j] + i wi[j]`` the realified ``2n x 2n`` system
    ``[[H - wr I, wi I], [-wi I, H - wr I]] x = b`` is solved with a tiny
    diagonal regularization (``ulp * ||H||`` — the LU must not hit an exact
    zero pivot); duplicate eigenvalues are separated by ``ulp``-scale
    perturbations exactly as dhsein does.  Returns ``(Vr, Vi)`` with
    columns normalized, rows ``>= k_eff`` zeroed.
    """
    H = jnp.asarray(H)
    n = H.shape[0]
    dt = H.dtype
    k_eff = jnp.asarray(n if k_eff is None else k_eff, jnp.int32)
    Hm, active = _embed(H, k_eff)
    eps = np.finfo(np.dtype(dt)).eps
    norm = jnp.max(jnp.abs(Hm)) + 1.0
    eps3 = eps * norm

    # separate duplicates: shift each eigenvalue by (number of earlier
    # near-identical eigenvalues) * 4 ulp ||H|| (dhsein's cluster rule)
    sep = 4.0 * eps3
    close = (jnp.abs(wr[None, :] - wr[:, None])
             + jnp.abs(wi[None, :] - wi[:, None])) <= sep
    earlier = jnp.tril(close, k=-1)
    wr = wr + earlier.sum(axis=1).astype(dt) * sep

    eye = jnp.eye(n, dtype=dt)
    b = _eigvec_rhs(n, dt)

    def solve_one(wrj, wij):
        A = Hm - wrj * eye
        M = jnp.block([[A, wij * eye], [-wij * eye, A]])
        M = M + eps3 * jnp.eye(2 * n, dtype=dt)
        x = jnp.linalg.solve(M, b)
        xr, xi = x[:n], x[n:]
        mask = active.astype(dt)
        xr, xi = xr * mask, xi * mask
        nrm = jnp.sqrt(jnp.sum(xr * xr + xi * xi))
        inv = jnp.where(nrm > 0, 1.0 / jnp.where(nrm > 0, nrm, 1.0), 0.0)
        return xr * inv, xi * inv

    Vr, Vi = jax.vmap(solve_one, out_axes=1)(wr, wi)
    return Vr, Vi


@partial(jax.jit, static_argnames=("p",))
@_full_precision
def hessenberg_ritz(H_ext, k_eff, tol, nev=None, p: int = 1):
    """Device-side Ritz analysis of the extended Hessenberg buffer: the
    full projected eigensolve + residuals + convergence count of one eigs
    check, with no host round-trip.

    ``H_ext`` is the ``(kdim+1, kdim)`` Arnoldi buffer, ``k_eff`` the
    (traced) active size.  Returns ``(wr, wi, res, Vr, Vi, n_conv, ok)``
    in modulus-descending order (matching the host path's
    ``argsort(-|w|)``); inactive slots carry ``res = +inf`` so they can
    never count as converged.  Residuals are the reference's
    ``|beta| * |last eigvec component|`` (IterativeSolvers.fypp:1069-1083)
    with ``beta = H_ext[k_eff, k_eff-1]``.

    ``n_conv`` counts converged residuals among the LEADING ``nev``
    (post-sort) entries — deliberately stricter than the reference's
    whole-spectrum count (IterativeSolvers.fypp:1087-1092), which can
    declare convergence while a *returned* leading pair still sits above
    tol (a trailing converged pair makes up the count).  ``nev = None``
    reproduces the whole-spectrum count.

    ``p > 1`` (static) handles a BLOCK Arnoldi buffer of shape
    ``(kdim + p, kdim)``: the interior eigensolve is unchanged (the
    Householder pre-reduction accepts the band-Hessenberg form), and the
    residual generalizes to ``||B y_last||`` with
    ``B = H_ext[k:k+p, k-p:k]`` the subdiagonal coupling block and
    ``y_last`` the trailing ``p`` eigenvector components (reference
    residual with blksize p: arnoldi.fypp:34-73 coupling).
    """
    H_ext = jnp.asarray(H_ext)
    kdim = H_ext.shape[1]
    H = H_ext[:kdim, :kdim]
    k_eff = jnp.asarray(k_eff, jnp.int32)
    wr, wi, ok = hessenberg_eigvals(H, k_eff)
    Vr, Vi = hessenberg_eigvecs(H, wr, wi, k_eff)
    active = jnp.arange(kdim) < k_eff
    if p == 1:
        km1 = jnp.maximum(k_eff - 1, 0)
        beta = jnp.abs(H_ext[k_eff, km1])
        last = jnp.sqrt(Vr[km1, :] ** 2 + Vi[km1, :] ** 2)
        res = jnp.where(active & ok, beta * last, jnp.inf)
    else:
        z0 = jnp.zeros((), k_eff.dtype)
        kmp = jnp.maximum(k_eff - p, 0)
        B = jax.lax.dynamic_slice(H_ext, (k_eff, kmp), (p, p))
        Vr_l = jax.lax.dynamic_slice(Vr, (kmp, z0), (p, kdim))
        Vi_l = jax.lax.dynamic_slice(Vi, (kmp, z0), (p, kdim))
        res = jnp.sqrt(jnp.sum((B @ Vr_l) ** 2 + (B @ Vi_l) ** 2, axis=0))
        res = jnp.where(active & ok, res, jnp.inf)
    order = jnp.argsort(-(wr * wr + wi * wi))
    wr, wi, res = wr[order], wi[order], res[order]
    Vr, Vi = Vr[:, order], Vi[:, order]
    lead = (jnp.arange(kdim)
            < jnp.asarray(kdim if nev is None else nev, jnp.int32))
    n_conv = jnp.sum(jnp.where(lead & jnp.isfinite(res), res < tol, False))
    return wr, wi, res, Vr, Vi, n_conv.astype(jnp.int32), ok
