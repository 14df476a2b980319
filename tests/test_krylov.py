"""Krylov process tests — algebraic-identity checks
(reference model: test/TestKrylov.fypp:42-514 — QR reconstruction +
orthonormality, pivoted QR on rank-deficient bases, Arnoldi residual
identity ||A X_k - X_{k+1} H|| ~ 0, Krylov-Schur invariance, Lanczos and
bidiagonalization analogues)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lightkrylov_tpu as lk
from lightkrylov_tpu import vectors
from lightkrylov_tpu.krylov import (
    arnoldi,
    arnoldi_block,
    bidiagonalization,
    initialize_arnoldi,
    initialize_bidiag,
    initialize_lanczos,
    is_orthonormal,
    krylov_schur,
    lanczos,
    qr,
    qr_pivoted,
)
from lightkrylov_tpu.krylov.arnoldi import initialize_arnoldi as _init

N = 128  # test_size (reference: TestUtils.fypp:18)
KDIM = 12


def _rand_mat(dtype, rng, shape):
    A = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.standard_normal(shape)
    return A.astype(dtype)


def _tols(dtype):
    return lk.rtol(dtype)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


# -- QR ----------------------------------------------------------------------

def test_qr_factorization(key, dtype):
    """||X - QR|| small + Q orthonormal (reference: TestKrylov.fypp:42-98)."""
    k = 6
    X = vectors.rand_basis(key, vectors.zeros_basis(jnp.zeros(N, dtype), k))
    Q, R, info = qr(X)
    assert int(info) == 0
    assert bool(is_orthonormal(Q, rtol=_tols(dtype)))
    Xm = np.asarray(jax.tree_util.tree_leaves(X)[0])
    Qm = np.asarray(jax.tree_util.tree_leaves(Q)[0])
    recon = np.asarray(R).T @ Qm  # column j: sum_i R[i,j] Q_i
    err = np.linalg.norm(recon - Xm) / np.linalg.norm(Xm)
    assert err < _tols(dtype)
    # R upper triangular
    assert np.allclose(np.tril(np.asarray(R), -1), 0, atol=10 * _tols(dtype))


def test_qr_breakdown_replacement(key, dtype):
    """Collinear columns -> random replacement, R[j,j] = 0, info = j
    (reference: qr.fypp:116-167)."""
    x = vectors.rand_like(key, jnp.zeros(N, dtype))
    X = vectors.stack([x, vectors.scal(2.0, x), vectors.rand_like(jax.random.fold_in(key, 1), x)])
    Q, R, info = qr(X, tol=float(np.sqrt(lk.atol(dtype))))
    assert int(info) == 2  # second column collinear (1-based)
    assert abs(complex(R[1, 1])) == 0.0
    assert bool(is_orthonormal(Q, rtol=_tols(dtype)))


def test_cholesky_qr2(key, dtype):
    """CholeskyQR2: Q orthonormal + exact reconstruction (matmul-based
    tall-skinny QR; no reference counterpart)."""
    from lightkrylov_tpu.krylov import cholesky_qr2

    k = 6
    X = vectors.rand_basis(key, vectors.zeros_basis(jnp.zeros(N, dtype), k))
    Q, R, info = cholesky_qr2(X)
    assert info == 0
    assert bool(is_orthonormal(Q, rtol=_tols(dtype)))
    Xm = np.asarray(jax.tree_util.tree_leaves(X)[0])
    Qm = np.asarray(jax.tree_util.tree_leaves(Q)[0])
    recon = np.asarray(R).T @ Qm
    err = np.linalg.norm(recon - Xm) / np.linalg.norm(Xm)
    assert err < _tols(dtype)
    assert np.allclose(np.tril(np.asarray(R), -1), 0, atol=10 * _tols(dtype))


def test_cholesky_qr2_rank_deficient_fallback(key, dtype_dp):
    """Rank deficiency: a zero column guarantees a NaN Cholesky pivot ->
    info=-1, and orthonormalize_basis falls back to the CGS2 path with
    random replacement.  A merely *collinear* column may round either way
    (the junk pivot direction acts as a random replacement) — the contract
    is: info=0 implies Q orthonormal."""
    from lightkrylov_tpu.krylov import cholesky_qr2, orthonormalize_basis

    dtype = dtype_dp
    x = vectors.rand_like(key, jnp.zeros(N, dtype))
    r = vectors.rand_like(jax.random.fold_in(key, 1), x)
    X0 = vectors.stack([x, vectors.zero_like(x), r])
    Q, _, info = cholesky_qr2(X0)
    assert info == -1
    Q = orthonormalize_basis(X0, key=key, method="cholqr2")
    assert bool(is_orthonormal(Q, rtol=_tols(dtype)))

    Xc = vectors.stack([x, vectors.scal(2.0, x), r])
    Qc, _, infoc = cholesky_qr2(Xc)
    assert infoc == -1 or bool(is_orthonormal(Qc))


def test_qr_pivoted_rank_deficient(key, dtype):
    """Pivoted QR on a built rank-deficient basis
    (reference: TestKrylov.fypp:100-174)."""
    k, r = 6, 3
    B = vectors.rand_basis(key, vectors.zeros_basis(jnp.zeros(N, dtype), r))
    Bm = jax.tree_util.tree_leaves(B)[0]
    C = _rand_mat(dtype, np.random.default_rng(3), (r, k))
    X = jnp.asarray(C).T @ Bm  # rank-r basis of k columns
    Q, R, perm, info = qr_pivoted(X)
    assert bool(is_orthonormal(Q, rtol=_tols(dtype)))
    # diag(R) decreasing in magnitude over the numerical rank
    d = np.abs(np.diag(np.asarray(R)))
    assert np.all(d[:r][:-1] >= d[:r][1:] - 1e-6)
    # reconstruction of the permuted basis
    Qm = np.asarray(jax.tree_util.tree_leaves(Q)[0])
    Xp = np.asarray(X)[np.asarray(perm)]
    err = np.linalg.norm(np.asarray(R).T @ Qm - Xp) / np.linalg.norm(Xp)
    assert err < 10 * _tols(dtype)


# -- Arnoldi -----------------------------------------------------------------

def test_arnoldi_identity(key, dtype, rng):
    """||A X_k - X_{k+1} H|| ~ 0 and orthonormal basis
    (reference: TestKrylov.fypp:183-240)."""
    A = _rand_mat(dtype, rng, (N, N))
    op = lk.DenseOperator(jnp.asarray(A))
    x0 = vectors.rand_like(key, jnp.zeros(N, dtype))
    X, H = initialize_arnoldi(x0, KDIM)
    X, H, info = arnoldi(op, X, H)
    assert int(info) == 0
    Xm = np.asarray(jax.tree_util.tree_leaves(X)[0])  # (KDIM+1, N)
    Hm = np.asarray(H)
    lhs = A @ Xm[:KDIM].T
    rhs = Xm.T @ Hm
    err = np.linalg.norm(lhs - rhs) / np.linalg.norm(Hm)
    assert err < _tols(dtype)
    assert bool(is_orthonormal(X, rtol=_tols(dtype)))


def test_arnoldi_incremental_matches_full(key, dtype, rng):
    """kstart/kend incremental calls give the same factorization
    (reference: arnoldi.fypp kstart/kend semantics)."""
    A = _rand_mat(dtype, rng, (N, N))
    op = lk.DenseOperator(jnp.asarray(A))
    x0 = vectors.rand_like(key, jnp.zeros(N, dtype))
    Xf, Hf = initialize_arnoldi(x0, KDIM)
    Xf, Hf, _ = arnoldi(op, Xf, Hf)
    Xi, Hi = initialize_arnoldi(x0, KDIM)
    for k in range(1, KDIM + 1):
        Xi, Hi, _ = arnoldi(op, Xi, Hi, kstart=k, kend=k)
    assert np.allclose(np.asarray(Hf), np.asarray(Hi), atol=10 * _tols(dtype))


def test_arnoldi_invariant_subspace(key, dtype):
    """Breakdown on an operator with an invariant subspace -> info = dim
    (reference: arnoldi.fypp:66-71)."""
    # block diagonal with a 3x3 leading block; seed inside the block
    rng = np.random.default_rng(5)
    A = np.zeros((N, N))
    A[:3, :3] = rng.standard_normal((3, 3))
    A[3:, 3:] = rng.standard_normal((N - 3, N - 3))
    A = A.astype(dtype)
    op = lk.DenseOperator(jnp.asarray(A))
    x0 = jnp.zeros(N, dtype).at[0].set(1.0)
    X, H = initialize_arnoldi(x0, KDIM)
    X, H, info = arnoldi(op, X, H, tol=1e-4 if np.dtype(dtype).itemsize <= 8 else 1e-10)
    assert 0 < int(info) <= 3


def test_block_arnoldi_identity(key, dtype, rng):
    """Block Arnoldi (p = 2) residual identity
    (reference: TestKrylov.fypp block variant :241-300)."""
    p, nblk = 2, 4
    kdim = p * nblk
    A = _rand_mat(dtype, rng, (N, N))
    op = lk.DenseOperator(jnp.asarray(A))
    X0 = vectors.rand_basis(key, vectors.zeros_basis(jnp.zeros(N, dtype), p))
    Q0, _, _ = qr(X0)
    X = vectors.zeros_basis(jnp.zeros(N, dtype), kdim + p)
    for i in range(p):
        X = vectors.set_column(X, i, vectors.get_column(Q0, i))
    H = jnp.zeros((kdim + p, kdim), dtype)
    X, H, info = arnoldi_block(op, X, H, p)
    Xm = np.asarray(jax.tree_util.tree_leaves(X)[0])
    Hm = np.asarray(H)
    err = np.linalg.norm(A @ Xm[:kdim].T - Xm.T @ Hm) / np.linalg.norm(Hm)
    assert err < _tols(dtype)
    assert bool(is_orthonormal(X, rtol=_tols(dtype)))


# -- Krylov-Schur restart ----------------------------------------------------

def test_krylov_schur_invariance(key, dtype_dp, rng):
    """After compression, the factorization identity still holds and the
    retained Ritz values are preserved (reference: TestKrylov.fypp:301-347)."""
    dtype = dtype_dp
    A = _rand_mat(dtype, rng, (N, N))
    op = lk.DenseOperator(jnp.asarray(A))
    x0 = vectors.rand_like(key, jnp.zeros(N, dtype))
    X, H = initialize_arnoldi(x0, KDIM)
    X, H, _ = arnoldi(op, X, H)
    ritz_before = np.sort_complex(np.linalg.eigvals(np.asarray(H)[:KDIM, :KDIM]))

    Xc, Hc, n = krylov_schur(X, H)
    assert 1 <= n < KDIM
    Xm = np.asarray(jax.tree_util.tree_leaves(Xc)[0])
    Hm = np.asarray(Hc)
    # extended identity on the compressed factorization
    err = np.linalg.norm(A @ Xm[:n].T - Xm[: n + 1].T @ Hm[: n + 1, :n])
    assert err < 1e-8 * np.linalg.norm(A)
    # selected Ritz values survive
    kept = np.linalg.eigvals(Hm[:n, :n])
    for lam in kept:
        assert np.min(np.abs(ritz_before - lam)) < 1e-8
    # basis still orthonormal over the active columns
    G = np.asarray(vectors.gram(Xc))[: n + 1, : n + 1]
    assert np.allclose(G, np.eye(n + 1), atol=1e-8)


def test_krylov_schur_continuation(key, dtype_dp, rng):
    """Arnoldi continuation after compression keeps the identity intact."""
    dtype = dtype_dp
    A = _rand_mat(dtype, rng, (N, N))
    op = lk.DenseOperator(jnp.asarray(A))
    x0 = vectors.rand_like(key, jnp.zeros(N, dtype))
    X, H = initialize_arnoldi(x0, KDIM)
    X, H, _ = arnoldi(op, X, H)
    Xc, Hc, n = krylov_schur(X, H)
    Xr, Hr, info = arnoldi(op, Xc, Hc, kstart=n + 1)
    assert int(info) == 0
    Xm = np.asarray(jax.tree_util.tree_leaves(Xr)[0])
    Hm = np.asarray(Hr)
    err = np.linalg.norm(A @ Xm[:KDIM].T - Xm.T @ Hm)
    assert err < 1e-8 * np.linalg.norm(A)
    assert bool(is_orthonormal(Xr, rtol=1e-8))


# -- Lanczos -----------------------------------------------------------------

def test_lanczos_identity(key, dtype, rng):
    """Tridiagonal identity on a Hermitian operator
    (reference: TestKrylov.fypp:356-430)."""
    M = _rand_mat(dtype, rng, (N, N))
    A = (M + M.conj().T) / 2
    op = lk.DenseOperator(jnp.asarray(A), is_hermitian=True)
    x0 = vectors.rand_like(key, jnp.zeros(N, dtype))
    X, T, = initialize_lanczos(x0, KDIM)
    X, T, info = lanczos(op, X, T)
    assert int(info) == 0
    Xm = np.asarray(jax.tree_util.tree_leaves(X)[0])
    Tm = np.asarray(T)
    err = np.linalg.norm(A @ Xm[:KDIM].T - Xm.T @ Tm) / np.linalg.norm(Tm)
    assert err < _tols(dtype)
    assert bool(is_orthonormal(X, rtol=_tols(dtype)))
    # T is (numerically) Hermitian tridiagonal in its leading block
    Tk = Tm[:KDIM, :KDIM]
    assert np.allclose(Tk, np.conj(Tk.T), atol=100 * _tols(dtype))


# -- Golub-Kahan -------------------------------------------------------------

def test_bidiagonalization_identity(key, dtype, rng):
    """A V_k = U_{k+1} B_k on a rectangular operator
    (reference: TestKrylov.fypp:431-514)."""
    m, n = N, N // 2
    A = _rand_mat(dtype, rng, (m, n))
    op = lk.DenseOperator(jnp.asarray(A))
    u0 = vectors.rand_like(key, jnp.zeros(m, dtype))
    U, V, B = initialize_bidiag(u0, jnp.zeros(n, dtype), KDIM)
    U, V, B, info = bidiagonalization(op, U, V, B)
    assert int(info) == 0
    Um = np.asarray(jax.tree_util.tree_leaves(U)[0])
    Vm = np.asarray(jax.tree_util.tree_leaves(V)[0])
    Bm = np.asarray(B)
    err = np.linalg.norm(A @ Vm.T - Um.T @ Bm) / np.linalg.norm(Bm)
    assert err < _tols(dtype)
    assert bool(is_orthonormal(U, rtol=_tols(dtype)))
    assert bool(is_orthonormal(V, rtol=_tols(dtype)))


def test_nan_sanitization_qr_arnoldi():
    """A NaN entering the factorization must surface as a *fatal* negative
    info, not silently pass the `beta < tol` breakdown branch (reference:
    qr.fypp:72-78,139-145 stops on isnan)."""
    import pytest
    from lightkrylov_tpu.krylov.qr import qr, qr_pivoted
    from lightkrylov_tpu.krylov.arnoldi import arnoldi, initialize_arnoldi
    from lightkrylov_tpu.utils.logger import LightKrylovError, check_info

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((4, 16)))
    Xbad = X.at[2, 3].set(jnp.nan)
    Q, R, info = qr(Xbad)
    assert int(info) < 0
    with pytest.raises(LightKrylovError):
        check_info(int(info), "qr")
    Q, R, perm, info = qr_pivoted(Xbad)
    assert int(info) < 0

    class NanOp(lk.LinearOperator):
        _children = ()
        _static = ()

        def matvec(self, x):
            return x * jnp.nan

    x0 = jnp.asarray(rng.standard_normal(16))
    X0, H = initialize_arnoldi(x0, 4)
    X1, H1, ainfo = arnoldi(NanOp(), X0, H)
    assert int(ainfo) < 0
    with pytest.raises(LightKrylovError):
        check_info(int(ainfo), "arnoldi")


def test_nan_sanitization_lanczos_bidiag():
    from lightkrylov_tpu.krylov.lanczos import lanczos, initialize_lanczos
    from lightkrylov_tpu.krylov.bidiag import bidiagonalization, initialize_bidiag

    class NanOp(lk.LinearOperator):
        _children = ()
        _static = ()
        is_hermitian = True

        def matvec(self, x):
            return x * jnp.nan

    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.standard_normal(16))
    X, T = initialize_lanczos(x0, 4)
    _, _, linfo = lanczos(NanOp(), X, T)
    assert int(linfo) < 0

    U, V, B = initialize_bidiag(x0, x0, 4)
    _, _, _, binfo = bidiagonalization(NanOp(), U, V, B)
    assert int(binfo) < 0


def test_arnoldi_block_dynamic_kstart():
    """Block Arnoldi accepts *traced* kstart/kend:
    one executable serves every restart cycle, and incremental growth
    matches the one-shot factorization."""
    from lightkrylov_tpu.krylov.arnoldi import arnoldi_block
    from lightkrylov_tpu import vectors

    rng = np.random.default_rng(3)
    n, p, kdim = 40, 2, 8
    Adata = jnp.asarray(rng.standard_normal((n, n)))
    A = lk.DenseOperator(Adata)
    b0 = jnp.asarray(rng.standard_normal((p, n)))
    from lightkrylov_tpu.krylov.qr import qr as _qr
    Q0, _, _ = _qr(b0)
    X = vectors.zeros_basis(jnp.zeros(n), kdim + p)
    X = jax.tree.map(lambda l, q: l.at[:p].set(q), X, Q0)
    H = jnp.zeros((kdim + p, kdim))

    # one-shot
    X1, H1, info1 = arnoldi_block(A, X, H, p)
    # incremental with dynamic (device-scalar) bounds under jit
    grow = jax.jit(lambda X, H, ks, ke: arnoldi_block(A, X, H, p,
                                                      kstart=ks, kend=ke))
    X2, H2 = X, H
    for b in range(kdim // p):
        X2, H2, info2 = grow(X2, H2, jnp.int32(b * p + 1),
                             jnp.int32((b + 1) * p))
    assert np.allclose(np.asarray(H1), np.asarray(H2), atol=1e-10)
    assert np.allclose(np.asarray(X1), np.asarray(X2), atol=1e-10)
    # factorization identity A X_k = X_{k+p} H
    AX = jax.vmap(A.matvec)(jax.tree.map(lambda l: l[:kdim], X1))
    XH = jnp.einsum("in,ik->kn", X1, H1)
    assert np.linalg.norm(np.asarray(AX) - np.asarray(XH.reshape(kdim, n))) < 1e-10


def test_dgs_check_orthonormal_flag():
    """The optional input-validation flag of double_gram_schmidt_step
    (reference: if_chk_orthonormal, gram_schmidt.fypp:26-34): an
    orthonormal basis passes (and the projection is unchanged), a
    non-orthonormal basis is a hard stop, and requesting the check under
    jit raises at trace time (eager-only validation)."""
    from lightkrylov_tpu.krylov.gram_schmidt import double_gram_schmidt_step
    from lightkrylov_tpu.utils.logger import LightKrylovError

    rng = np.random.default_rng(17)
    key = jax.random.PRNGKey(4)
    X = vectors.rand_basis(key, vectors.zeros_basis(jnp.zeros(N), 6))
    Q = lk.orthonormalize_basis(X)
    # zero-padded buffer: unfilled columns allowed by the invariant
    Qbuf = jax.tree.map(lambda l: jnp.concatenate([l, jnp.zeros_like(l[:2])]), Q)
    y = jnp.asarray(rng.standard_normal(N))
    y1, p1 = double_gram_schmidt_step(y, Qbuf)
    y2, p2 = double_gram_schmidt_step(y, Qbuf, check_orthonormal=True)
    assert np.allclose(np.asarray(y1), np.asarray(y2))
    assert np.allclose(np.asarray(p1), np.asarray(p2))
    with pytest.raises(LightKrylovError):
        double_gram_schmidt_step(y, X, check_orthonormal=True)  # raw basis
    with pytest.raises(RuntimeError):
        jax.jit(lambda y, X: double_gram_schmidt_step(
            y, X, check_orthonormal=True))(y, Qbuf)
