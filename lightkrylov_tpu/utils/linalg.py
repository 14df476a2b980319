"""Dense linear-algebra utilities for the small projected problems.

Counterpart of ``src/Utilities/Utils.fypp`` +
``submodule_utility_functions.fypp``: LAPACK-convention ``eig`` (GEEV),
``ordschur`` (TRSEN), ``sqrtm``, and the Givens-rotation helpers used by the
GMRES least-squares recursion (reference: Utils.fypp:128-268).

The projected problems are k x k with k ~ O(100): tiny.  Hermitian eig, SVD
and ``expm`` run on-device via XLA; general (non-Hermitian) eigendecomposition
and Schur reordering have no device lowering in XLA, so they run **eagerly on
the host** (``device_get`` -> LAPACK -> back) — a few kilobytes on the wire,
negligible next to one Krylov matvec.  They are not wrapped in
``jax.pure_callback``: all call sites are eager driver code between jitted
Krylov sweeps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg as _sla

from .. import constants

__all__ = [
    "eig",
    "eigh",
    "svd",
    "schur",
    "ordschur",
    "schur_select",
    "sqrtm",
    "expm",
    "givens_rotation",
    "apply_givens_rotation",
    "solve_triangular",
    "to_host",
]


def _complex_of(dtype):
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        return dtype
    return np.dtype(np.complex64) if dtype == np.float32 else np.dtype(np.complex128)


@jax.jit
def _split_reim(x):
    return jnp.real(x), jnp.imag(x)


def _host(x):
    """Fetch a (small) device array to host numpy.

    Complex arrays are split into (real, imag) by ONE jitted call and
    recombined on the host (harmless: the same bytes cross either way).
    Real arrays transfer directly.
    """
    if not isinstance(x, jax.Array):
        return np.asarray(x)  # already host data: no transfer
    if np.issubdtype(x.dtype, np.complexfloating):
        re, im = jax.device_get(_split_reim(x))
        return (np.asarray(re) + 1j * np.asarray(im)).astype(x.dtype)
    return np.asarray(jax.device_get(x))


def to_host(x):
    """Public device->host fetch (complex arrays split re/im inside one
    jitted call — see ``_host``)."""
    return _host(x)


def eig(A):
    """Eigendecomposition of a small dense matrix, LAPACK GEEV convention
    (reference: Utils.fypp ``eig``; used on the projected Hessenberg,
    IterativeSolvers.fypp:1065).

    Eager host LAPACK; returns numpy ``(w, V)`` complex regardless of input
    dtype.  Must not be called under ``jit`` (the projected problem lives in
    the eager driver layer by design).
    """
    a = _host(A)
    cdt = _complex_of(a.dtype)
    w, v = np.linalg.eig(a)
    return w.astype(cdt), v.astype(cdt)


def eigh(A):
    """Hermitian eigendecomposition — on-device (XLA lowers eigh)."""
    return jnp.linalg.eigh(A)


def svd(A, full_matrices: bool = False):
    """Singular value decomposition — on-device."""
    return jnp.linalg.svd(A, full_matrices=full_matrices)


def schur(A, output: str | None = None):
    """Schur decomposition ``A = Z T Z^H``, eager host LAPACK
    (reference: stdlib ``schur`` used by ``krylov_schur``,
    BaseKrylov.fypp:807).

    ``output``: 'real' (default for real A, 2x2 blocks for conjugate pairs,
    Z real — keeps a real Krylov basis real after compression) or 'complex'.
    """
    a = _host(A)
    if output is None:
        output = "complex" if np.issubdtype(a.dtype, np.complexfloating) else "real"
    T, Z = _sla.schur(a, output=output)
    return T.astype(a.dtype), Z.astype(a.dtype)


def ordschur(T, Z, select_mask):
    """Reorder a Schur factorization so that the eigenvalues flagged in
    ``select_mask`` occupy the leading block — LAPACK TRSEN
    (reference: ``ordschur``, Utils.fypp:128-268; used by ``krylov_schur``,
    BaseKrylov.fypp:813).

    For real Schur forms LAPACK moves whole 2x2 conjugate-pair blocks, which
    is exactly the behavior the Krylov-Schur restart requires.
    """
    T = _host(T)
    Z = _host(Z)
    mask = np.asarray(select_mask).astype(np.int32)
    if np.issubdtype(T.dtype, np.complexfloating):
        trsen = _sla.lapack.ctrsen if T.dtype == np.complex64 else _sla.lapack.ztrsen
    else:
        trsen = _sla.lapack.strsen if T.dtype == np.float32 else _sla.lapack.dtrsen
    res = trsen(mask, T, Z, job="N")
    Ts, Zs = res[0], res[1]
    return Ts.astype(T.dtype), Zs.astype(Z.dtype)


def schur_select(A, select):
    """One-shot sorted Schur form: decompose ``A``, apply the *global*
    eigenvalue selector ``select(eigvals) -> bool mask``, and reorder.

    The selector interface is global (it sees the whole spectrum at once —
    e.g. the median-based selector of eigs,
    IterativeSolvers.fypp:1137-1142), which scipy's per-eigenvalue ``sort``
    cannot express; hence schur + selector + TRSEN composed here.

    Returns numpy ``(T, Z, n_selected)``.
    """
    a = _host(A)
    is_cplx = np.issubdtype(a.dtype, np.complexfloating)
    T, Z = _sla.schur(a, output="complex" if is_cplx else "real")
    w = np.diag(T) if is_cplx else _sla.eigvals(T)
    mask = np.asarray(select(w), dtype=bool)
    if not is_cplx:
        # LAPACK selects whole 2x2 blocks; make the mask pair-consistent.
        i, n = 0, T.shape[0]
        mask = mask.copy()
        while i < n - 1:
            if abs(T[i + 1, i]) > 0:
                both = mask[i] or mask[i + 1]
                mask[i] = mask[i + 1] = both
                i += 2
            else:
                i += 1
    Ts, Zs = ordschur(T, Z, mask)
    return Ts, Zs, int(mask.sum())


def sqrtm(A, hermitian: bool = True):
    """Matrix square root of a positive-(semi)definite matrix via
    eigendecomposition — on-device — returning ``(sqrtA, info)``
    (reference: ``sqrtm``, submodule_utility_functions.fypp:123-163).

    ``info`` follows the reference's convention: 0 for a (numerically)
    positive-definite input, 1 when eigenvalues at or below ``10*atol``
    were clipped to zero (positive *semi*-definite input) — so an
    indefinite input is detectable instead of being silently projected.
    ``info`` is a traced int32 under ``jit``, a Python int eagerly.

    Eagerly, the reference's symmetry validation also runs:
    ``0.5*max|A - A^H| > rtol`` is fatal (``stop_error``), ``> 10*atol``
    logs a warning (submodule_utility_functions.fypp:133-144).  Under
    ``jit`` the symmetry check is skipped (no data-dependent abort).
    """
    A = jnp.asarray(A)
    rdt = constants.real_dtype_of(A.dtype)
    tol = 10.0 * constants.atol(rdt)
    sym_err = 0.5 * jnp.max(jnp.abs(A - A.conj().T))
    if not isinstance(sym_err, jax.core.Tracer):
        err = float(sym_err)
        if err > constants.rtol(rdt):
            from .logger import stop_error

            stop_error(
                f"Input matrix is not Hermitian. 0.5*max|A - A^H| = {err:.2e}",
                "utils", "sqrtm")
        elif err > tol:
            from .logger import log_warning

            log_warning(
                f"Input matrix is not exactly Hermitian. "
                f"0.5*max|A - A^H| = {err:.2e}", "utils", "sqrtm")
    w, V = jnp.linalg.eigh(A)
    clipped = w <= tol
    info = jnp.any(clipped).astype(jnp.int32)
    w = jnp.where(clipped, 0.0, w)
    # HIGHEST precision: a default f32 matmul may round to TF32 on a GPU
    # (~3 digits lost); the k x k reconstruction is tiny, so full precision
    # is free (the same rule as vectors.innerprod).
    sqrtA = jnp.matmul(V * jnp.sqrt(w), V.conj().T,
                       precision=jax.lax.Precision.HIGHEST)
    if not isinstance(info, jax.core.Tracer):
        info = int(info)
    return sqrtA, info


def expm(A):
    """Dense matrix exponential — on-device Pade scaling-and-squaring
    (used for the projected exponential, reference: ExpmLib.fypp:207).
    Traced at full f32 matmul precision: the squaring phase would compound
    TF32 rounding."""
    with jax.default_matmul_precision("float32"):
        return jax.scipy.linalg.expm(A)


def givens_rotation(a, b):
    """Compute ``(c, s)`` zeroing ``b`` against ``a``
    (reference: ``givens_rotation``, Utils.fypp:128-268): complex-safe,
    ``c`` real, ``s`` same dtype as inputs."""
    anorm = jnp.abs(a)
    bnorm = jnp.abs(b)
    d = jnp.sqrt(anorm**2 + bnorm**2)
    d = jnp.where(d == 0, 1.0, d)
    c = anorm / d
    # Phase-correct sine for complex entries; reduces to b/d for real.
    phase = jnp.where(anorm == 0, 1.0 + 0.0 * a, a / jnp.where(anorm == 0, 1.0, anorm))
    s = jnp.conj(phase) * b / d
    c = jnp.where((anorm == 0) & (bnorm == 0), 1.0, c)
    s = jnp.where((anorm == 0) & (bnorm == 0), 0.0 * s, s)
    return c.real, s


def apply_givens_rotation(h, c, s, k):
    """Apply the k stored rotations to column ``h`` (length >= k+2), compute
    the new rotation annihilating ``h[k+1]``, and return the updated column
    and rotation arrays (reference: ``apply_givens_rotation``,
    Utils.fypp:128-268; used in gmres.fypp:177-182).

    All arrays are fixed-size buffers; ``k`` may be traced.
    """
    n = c.shape[0]

    def body(i, hc):
        h_ = hc
        hi = h_[i]
        hip = h_[i + 1]
        ci = c[i]
        si = s[i]
        new_hi = ci * hi + jnp.conj(si) * hip
        new_hip = -si * hi + ci * hip
        apply = i < k
        h_ = h_.at[i].set(jnp.where(apply, new_hi, hi))
        h_ = h_.at[i + 1].set(jnp.where(apply, new_hip, hip))
        return h_

    h = jax.lax.fori_loop(0, n, body, h)
    ck, sk = givens_rotation(h[k], h[k + 1])
    r = ck * h[k] + jnp.conj(sk) * h[k + 1]
    h = h.at[k].set(r)
    h = h.at[k + 1].set(jnp.zeros((), h.dtype))
    c = c.at[k].set(ck.astype(c.dtype))
    s = s.at[k].set(sk)
    return h, c, s


def solve_triangular(R, b, lower: bool = False):
    """Triangular solve for the GMRES least-squares back-substitution
    (reference: ``trtrs`` call, gmres.fypp:200)."""
    return jax.scipy.linalg.solve_triangular(R, b, lower=lower)


def assert_shape(A, shape, name: str = "array") -> None:
    """Shape guard (reference: ``assert_shape``, Utils.fypp:85-116)."""
    if tuple(A.shape) != tuple(shape):
        from .logger import stop_error

        stop_error(f"{name} has shape {tuple(A.shape)}, expected {tuple(shape)}",
                   "utils", "assert_shape")


def log2(x):
    """Base-2 logarithm (reference: ``log2``, Utils.fypp:37-60)."""
    return jnp.log(x) / jnp.log(2.0)
