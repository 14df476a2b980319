"""Krylov-Schur restart: compress an Arnoldi factorization onto a selected
invariant-subspace approximation.

Counterpart of ``krylov_schur`` (reference:
src/Krylov/BaseKrylov.fypp:714-837): Schur-decompose the Hessenberg, let a
*global* user selector flag eigenvalues to keep, reorder the Schur form
(``ordschur``), compress the basis with a tall-skinny GEMM
``X' = X Z[:, :n]`` (BaseKrylov.fypp:821 — ``linear_combination``) and
rebuild the Hessenberg with the coupling row
``b = H[kdim, kdim-1] * Z[kdim-1, :n]`` placed at row ``n``
(BaseKrylov.fypp:782-834).

This runs *eagerly* between jitted Arnoldi sweeps: the Schur step is a host
computation anyway (XLA has no device non-Hermitian Schur), and the restart
size ``n`` must be concrete for the driver.  The only O(N) work — the basis
compression — is a single jitted on-device GEMM; everything else is k x k
host arithmetic.

After compression the extended factorization reads
``A X[:, :n] = X[:, :n+1] H[:n+1, :n]`` with ``H[:n, :n]`` (quasi-)triangular
and the spike row at index ``n``; Arnoldi continuation from
``kstart = n + 1`` restores the Hessenberg-plus-spike structure whose dense
eigensolve yields the restarted Ritz values.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import vectors
from ..utils import linalg
from ..utils.hessenberg import francis_filter, ordschur_device, schur_real

__all__ = ["iram_restart", "krylov_schur", "krylov_schur_device",
           "median_selector"]


def median_selector(eigvals):
    """Default restart selector: keep eigenvalues with modulus above the
    median (reference: the median-of-|lambda| selector used by eigs,
    IterativeSolvers.fypp:1099-1100,1137-1142)."""
    mods = np.abs(eigvals)
    return mods > np.median(mods)


@jax.jit
def _compress_basis(X, Z):
    """On-device compression: X'[:, j] = sum_i Z[i, j] X[:, i] over the
    leading kdim columns (tall-skinny GEMM, BaseKrylov.fypp:821)."""
    kdim = Z.shape[0]
    X_lead = jax.tree.map(lambda l: l[:kdim], X)
    return vectors.linear_combination(X_lead, Z)


@jax.jit
def iram_restart(X, H, n_target):
    """Fully on-device restart via the exact-shift IRAM filter
    (:func:`~lightkrylov_tpu.utils.hessenberg.francis_filter`) — the
    device-mode replacement for :func:`krylov_schur`'s host
    ``schur``/``ordschur`` step when the selection is the default
    keep-``n_target``-largest-by-modulus (the reference's median selector
    intent, IterativeSolvers.fypp:1099-1100).

    Applies the filter sweeps to ``H``, compresses the basis with the
    accumulated ``Z[:, :n]`` (tall-skinny GEMM), and forms the new
    residual by the standard IRAM update
    ``f = Hf[n, n-1] (X Z)[:, n] + beta Z[kdim-1, n-1] x_res``.  Unlike
    the Krylov-Schur arrow form, the result is a PURE Arnoldi
    factorization: ``H'`` is Hessenberg with a single coupling
    ``H'[n, n-1] = ||f||``.

    Returns ``(X', H', n, ok)`` with ``n`` a device scalar (usable
    directly as ``kstart = n + 1`` for the next jitted sweep — no host
    round-trip) and ``ok`` the filter eigensolve's convergence flag
    (``False`` only means the shifts aimed poorly; the factorization
    stays exact either way).
    """
    kdim = H.shape[1]
    Hk = H[:kdim, :kdim]
    Hf, Z, n, ok = francis_filter(Hk, n_target)
    idx = jnp.arange(kdim)
    beta = H[kdim, kdim - 1]
    nm1 = jnp.maximum(n - 1, 0)

    # compress columns 0..n (column n feeds the residual update)
    Zc = jnp.where(idx[None, :] <= n, Z, 0.0)
    X_lead = jax.tree.map(lambda l: l[:kdim], X)
    Xc = vectors.linear_combination(X_lead, Zc)
    v_next = vectors.get_column(Xc, n)
    x_res = vectors.get_column(X, kdim)
    c1 = Hf[n, nm1]
    c2 = beta * Z[kdim - 1, nm1]
    f = jax.tree.map(lambda a, b: c1 * a.astype(Hf.dtype) + c2 * b,
                     v_next, x_res)
    bn = vectors.norm(f)
    inv = jnp.where(bn > 0, 1.0 / jnp.where(bn == 0, 1.0, bn), 0.0)
    v_new = vectors.scal(inv.astype(Hf.dtype), f)

    # new basis: kept block, residual direction at column n, zeros beyond
    # (buffer invariant: unfilled columns exactly zero)
    Xc = jax.tree.map(
        lambda l: jnp.where((idx < n).reshape((kdim,) + (1,) * (l.ndim - 1)),
                            l, 0.0),
        Xc)
    X_new = jax.tree.map(
        lambda c, full: jnp.concatenate([c, jnp.zeros_like(full[:1])],
                                        axis=0), Xc, X)
    X_new = vectors.set_column(X_new, n, v_new)

    mask = (idx[:, None] < n) & (idx[None, :] < n)
    H_new = jnp.zeros_like(H)
    H_new = H_new.at[:kdim, :kdim].set(jnp.where(mask, Hf, 0.0))
    H_new = H_new.at[n, nm1].set(bn.astype(Hf.dtype))
    return X_new, H_new, n, ok


@partial(jax.jit, static_argnames=("p",))
def krylov_schur_device(X, H, sel_wr, sel_wi, sel_mask, p: int = 1,
                        k_eff=None):
    """Fully on-device Krylov-Schur restart for an ARBITRARY selection —
    the device-mode counterpart of :func:`krylov_schur` (reference:
    BaseKrylov.fypp:714-837) for real dtypes, with the host LAPACK
    ``schur``/``ordschur`` step replaced by the jitted
    :func:`~lightkrylov_tpu.utils.hessenberg.schur_real` +
    :func:`~lightkrylov_tpu.utils.hessenberg.ordschur_device`.  Unlike
    :func:`iram_restart` this handles ANY selector and ANY input form
    (Hessenberg or the post-restart arrow form — the internal Householder
    reduction covers both).

    The selector itself is host code (a global function of the spectrum,
    IterativeSolvers.fypp:1137-1142), so selection arrives by VALUE:
    ``sel_wr``/``sel_wi`` are eigenvalues in any order (typically the
    modulus-descending list the eigs driver already fetched for its
    convergence check) with ``sel_mask`` the selector's boolean verdict
    for each; every diagonal block of the device Schur form takes the flag
    of its nearest-by-value entry.  The only host->device traffic is the
    kdim-bool mask.

    Returns ``(X', H', n, ok)`` with the same static buffer shapes —
    ``H'`` the reordered quasi-triangular leading block plus the coupling
    row ``b = beta * Z[kdim-1, :n]`` at row ``n`` (arrow form), columns
    ``> n`` zeroed, residual vector moved to column ``n``; ``n`` is a
    device scalar usable directly as ``kstart = n + 1``.  ``ok`` False
    means a Schur-form block swap was rejected (near-coincident
    eigenvalues across the selection boundary) — the output is still an
    exact factorization, but compressed onto a partially reordered (hence
    possibly unintended) subspace; callers should then route the NEXT
    restart to the host path.

    ``p > 1`` (static) restarts a BLOCK Arnoldi factorization (buffer
    shapes ``kdim + p`` / ``(kdim + p, kdim)``): the coupling is the
    ``p x p`` block ``B = H[kdim:kdim+p, kdim-p:kdim]``, the spike becomes
    the ``p``-row block ``B @ Zs[kdim-p:, :n]``, and the ``p`` residual
    directions (the old trailing block) move to columns ``n .. n+p-1``.
    ``n`` is exactly the (pair-consistent) selected count, clamped to
    ``[1, kdim - p]`` — continuation is offset-aligned (block starts at
    ``n, n+p, ...``; ``arnoldi_block_step`` takes a column offset), the
    block Krylov-Schur formulation.  ``k_eff`` (traced; block mode only)
    is the active square size when the previous sweep stopped short of
    ``kdim`` (offset continuation leaves up to ``p - 1`` columns unused
    per cycle); the Schur step runs on the embedded active block and the
    coupling/residual blocks are read at ``k_eff``.
    """
    kdim = H.shape[1]
    Hk = H[:kdim, :kdim]
    idx = jnp.arange(kdim)
    if p == 1 or k_eff is None:
        ke = jnp.int32(kdim)
    else:
        ke = jnp.asarray(k_eff, jnp.int32)
    T, Zs, wr, wi, ok1 = schur_real(Hk, k_eff=None if p == 1 else ke)
    # nearest-by-value mask transfer onto the Schur diagonal positions
    d = ((wr[:, None] - sel_wr[None, :]) ** 2
         + (wi[:, None] - sel_wi[None, :]) ** 2)
    sel = jnp.asarray(sel_mask, bool)[jnp.argmin(d, axis=1)]
    if p > 1:
        sel = sel & (idx < ke)  # inactive (embedded-identity) positions
    T, Zs, sel, ok2 = ordschur_device(T, Zs, sel)
    n = jnp.sum(sel).astype(jnp.int32)
    if p == 1:
        # clamp the keep count to [1, kdim-1] without splitting a 2x2 block
        n = jnp.where(n < 1,
                      jnp.where(T[1, 0] != 0, 2, 1).astype(jnp.int32), n)
        n = jnp.where(n > kdim - 1,
                      jnp.where(T[kdim - 1, kdim - 2] != 0,
                                kdim - 2, kdim - 1).astype(jnp.int32), n)
    else:
        # keep EXACTLY the selected count (pair-consistency guarantees n
        # never splits a 2x2 block); clamp to [1, min(ke, kdim - p)] so at
        # least one continuation block step fits
        n = jnp.where(n < 1,
                      jnp.where(T[1, 0] != 0, 2, 1).astype(jnp.int32), n)
        hi = jnp.minimum(ke - 1, jnp.int32(kdim - p))
        n = jnp.where(n > hi,
                      jnp.where(T[hi, hi - 1] != 0, hi - 1, hi
                                ).astype(jnp.int32), n)

    mask2 = (idx[:, None] < n) & (idx[None, :] < n)
    H_new = jnp.zeros_like(H)
    H_new = H_new.at[:kdim, :kdim].set(jnp.where(mask2, T, 0.0))
    if p == 1:
        beta = H[kdim, kdim - 1]
        spike = jnp.where(idx < n, beta * Zs[kdim - 1, :], 0.0)
        H_new = H_new.at[n, :].set(spike)
    else:
        z0 = jnp.zeros((), ke.dtype)
        B = jax.lax.dynamic_slice(H, (ke, ke - p), (p, p))
        Zl = jax.lax.dynamic_slice(Zs, (ke - p, z0), (p, kdim))
        spike = jnp.where(idx[None, :] < n, jnp.matmul(
            B, Zl, precision=jax.lax.Precision.HIGHEST), 0.0)
        H_new = jax.lax.dynamic_update_slice(
            H_new, spike.astype(H_new.dtype), (n, z0))

    Zc = jnp.where(idx[None, :] < n, Zs, 0.0)
    X_lead = jax.tree.map(lambda l: l[:kdim], X)
    Xc = vectors.linear_combination(X_lead, Zc)
    X_new = jax.tree.map(
        lambda c, full: jnp.concatenate(
            [c, jnp.zeros_like(full[:p])], axis=0), Xc, X)
    if p == 1:
        X_new = vectors.set_column(X_new, n, vectors.get_column(X, kdim))
    else:
        res_blk = jax.tree.map(
            lambda l: jax.lax.dynamic_slice_in_dim(l, ke, p, axis=0), X)
        X_new = vectors.set_columns_block(X_new, n, res_blk)
    return X_new, H_new, n, ok1 & ok2


def krylov_schur(X, H, select=None):
    """Compress the factorization ``(X, H)`` (full kdim columns + residual
    column) onto the ``n`` selected Ritz directions.

    Returns ``(X, H, n)`` with the same static buffer shapes — columns
    ``> n`` zeroed, residual vector moved to column ``n`` — ready for an
    Arnoldi continuation from ``kstart = n + 1``
    (reference: BaseKrylov.fypp:714-837).
    """
    if select is None:
        select = median_selector
    kdim = H.shape[1]
    Hk = H[:kdim, :kdim]
    Tn, Zn, n = linalg.schur_select(Hk, select)  # eager host LAPACK
    # Degenerate selections would stall the restart loop: clamp to [1, kdim-1].
    n = max(1, min(n, kdim - 1))
    beta = linalg.to_host(H[kdim, kdim - 1])

    # Host-side k x k assembly of the new extended Hessenberg.
    H_new = np.zeros(H.shape, dtype=Tn.dtype)
    H_new[:n, :n] = Tn[:n, :n]
    H_new[n, :n] = beta * Zn[kdim - 1, :n]

    # Device-side basis compression with the masked rotation.
    Zm = np.zeros_like(Zn)
    Zm[:, :n] = Zn[:, :n]
    Xc = _compress_basis(X, jnp.asarray(Zm))

    Xres = vectors.get_column(X, kdim)
    X_new = jax.tree.map(
        lambda c, full: jnp.concatenate([c, jnp.zeros_like(full[:1])], axis=0),
        Xc, X,
    )
    X_new = vectors.set_column(X_new, n, Xres)
    return X_new, jnp.asarray(H_new), n
