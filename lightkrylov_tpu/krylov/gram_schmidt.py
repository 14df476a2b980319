"""Classical Gram-Schmidt with re-orthogonalization (CGS2).

Counterpart of ``src/Krylov/gram_schmidt.fypp``: classical GS
projection of a vector (or block) against an orthonormal basis —
``proj = innerprod(X, y); y -= X proj`` (gram_schmidt.fypp:141-146,187-192) —
and ``double_gram_schmidt_step`` = two passes with coefficients summed
(CGS2, gram_schmidt.fypp:38-49,85-97).

The design point (SURVEY.md §2 item 3): the k inner products of one pass
are batched into a *single* reshaped matmul via :func:`vectors.innerprod`,
so on a sharded mesh each CGS pass costs exactly one fused all-reduce —
the "low-synch" property the reference obtains only implicitly through
its abstract ``innerprod``.

Buffer convention: the basis ``X`` is a fixed-size stacked buffer whose
unfilled columns are exactly zero; projections against the full buffer are
then algebraically exact without masks.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import constants, vectors

__all__ = [
    "orthogonalize_against_basis",
    "double_gram_schmidt_step",
]

#: Chunk width for active-prefix projections (see
#: :func:`vectors.innerprod_prefix`): callers that pass the filled column
#: count ``k`` read only ~k (not kdim) columns per CGS pass.  Set to None to
#: force full-buffer reads — one fused all-reduce per pass instead of one
#: per live chunk, the better trade on latency-bound multi-host meshes.
DEFAULT_CHUNK: int | None = 8

#: Prefix chunking only engages for buffers of at least this many columns:
#: each chunk costs an HLO conditional whose fixed overhead outweighs the
#: skipped traffic for small buffers, while for large kdim the saved
#: traffic dominates.  This value and DEFAULT_CHUNK were tuned on an earlier
#: accelerator and are not yet measured on a GPU (ROADMAP A4).
MIN_PREFIX_COLS: int = 48

#: Sentinel distinguishing "chunk not given" (-> DEFAULT_CHUNK) from an
#: explicit ``chunk=None`` (-> force the monolithic single-all-reduce path,
#: the better trade on latency-bound multi-host meshes).
_UNSET = object()


def _check_orthonormal_input(X) -> None:
    """Eager orthonormality validation of the basis buffer (reference:
    ``if_chk_orthonormal``, gram_schmidt.fypp:26-34 — logs when orthonormal,
    ``stop_error`` otherwise).

    Zero (unfilled) buffer columns are permitted: the check is
    ``||X^H X - diag(live)||_F < rtol_sp`` with ``live`` flagging columns of
    non-negligible norm, matching the zero-column buffer invariant.
    """
    import jax

    from ..utils.logger import log_information, stop_error

    G = vectors.gram(X)
    if isinstance(G, jax.core.Tracer):
        raise RuntimeError(
            "check_orthonormal=True is an eager-only validation; it cannot "
            "abort on traced data inside jit. Validate the basis outside "
            "the jitted region instead.")
    d = jnp.real(jnp.diagonal(G))
    live = d > 0.5
    defect = float(jnp.linalg.norm(G - jnp.diag(live.astype(G.dtype))))
    if defect < constants.rtol(jnp.float32):
        log_information(
            "Input basis orthonormal. Remove this check unless necessary "
            "for better performance", "krylov", "double_gram_schmidt_step")
    else:
        stop_error(f"Input basis not orthonormal (defect {defect:.3e}).",
                   "krylov", "double_gram_schmidt_step")


def orthogonalize_against_basis(y, X, k=None, chunk=_UNSET):
    """Single CGS pass: project ``y`` (vector or stacked block) against the
    basis buffer ``X`` and subtract.

    Returns ``(y_orth, proj)`` where ``proj = X^H y`` has shape ``(m,)`` for a
    vector or ``(m, p)`` for a block (reference:
    gram_schmidt.fypp:141-146,187-192).

    ``k`` (optional, may be traced): number of filled buffer columns; when
    given, only basis chunks intersecting ``[0, k)`` are streamed from HBM
    (exact by the zero-column buffer invariant) — the reference's
    ``X(:k)`` growing projection without dynamic shapes.

    ``chunk``: chunk width for the active-prefix reads; defaults to
    ``DEFAULT_CHUNK``.  Pass ``chunk=None`` explicitly to force the
    monolithic full-buffer path (one fused all-reduce per pass).
    """
    if chunk is _UNSET:
        chunk = DEFAULT_CHUNK
    if k is None or chunk is None or \
            vectors.basis_size(X) < MIN_PREFIX_COLS:
        proj = vectors.innerprod(X, y)
        correction = vectors.linear_combination(X, proj)
    else:
        proj = vectors.innerprod_prefix(X, y, k, chunk)
        correction = vectors.linear_combination_prefix(X, proj, k, chunk)
    y_orth = vectors.axpby(1.0, y, -1.0, correction) if proj.ndim == 1 else \
        vectors.axpby_basis(1.0, y, -1.0, correction)
    return y_orth, proj


def double_gram_schmidt_step(y, X, return_info: bool = False, k=None,
                             chunk=_UNSET, check_orthonormal: bool = False):
    """CGS2: two projection passes, coefficients summed
    (reference: ``double_gram_schmidt_step``, gram_schmidt.fypp:38-49,85-97).

    Two passes of classical Gram-Schmidt restore orthogonality to machine
    precision ("twice is enough"), while keeping each pass a single batched
    reduction — the bandwidth-friendly alternative to modified Gram-Schmidt's k
    sequential dots.

    Returns ``(y_orth, proj)`` with ``proj`` the summed coefficients.  With
    ``return_info=True`` a third element is appended: the 1-based index of
    a vanished projected column (norm below the dtype's atol), 0 when none
    did — the reference's zero-vector flag (gram_schmidt.fypp:127,171-173).
    Intentional deviations from the reference's flag, documented here
    because callers ported from reference logic read this value:

    * the reference flags a zero *input* vector (pre-projection norm below
      atol); this implementation checks the *post-CGS2* norm, which is
      strictly stronger — it additionally catches inputs that lie inside
      the span of ``X`` (the breakdown the callers actually care about);
    * for blocks the reference's Fortran loop overwrites ``info`` and ends
      up reporting the *last* vanished column index, while this
      implementation reports the *first* (the earliest breakdown).

    The info value is a traced int32 scalar, usable inside jitted loops.

    ``check_orthonormal``: optional input validation mirroring the
    reference's ``if_chk_orthonormal`` flag (gram_schmidt.fypp:26-34): when
    True, assert that ``X`` is orthonormal (zero buffer columns allowed by
    the buffer invariant) and ``stop_error`` otherwise.  Unlike the
    reference this defaults to **False**: the hot call sites here live
    inside jitted ``while_loop`` bodies where a data-dependent host abort
    cannot exist — the check is an eager-only debugging aid and raises at
    trace time if requested under ``jit``.

    ``k``/``chunk``: active-prefix projection — see
    :func:`orthogonalize_against_basis`.
    """
    if check_orthonormal:
        _check_orthonormal_input(X)
    y1, p1 = orthogonalize_against_basis(y, X, k=k, chunk=chunk)
    y2, p2 = orthogonalize_against_basis(y1, X, k=k, chunk=chunk)
    if not return_info:
        return y2, p1 + p2
    tol = constants.atol(constants.real_dtype_of(vectors.dtype_of(y2)))
    if p1.ndim == 1:  # single vector
        vanished = vectors.norm(y2) < tol
        info = jnp.where(vanished, 1, 0).astype(jnp.int32)
    else:  # stacked block: flag the first vanished column
        norms = jnp.sqrt(jnp.real(jnp.diagonal(vectors.gram(y2))))
        small = norms < tol
        first = jnp.argmax(small).astype(jnp.int32)
        info = jnp.where(jnp.any(small), first + 1, 0).astype(jnp.int32)
    return y2, p1 + p2, info
