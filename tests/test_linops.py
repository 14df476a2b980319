"""Operator algebra tests (reference model: test/TestLinops.fypp —
adjoint/scaled/axpby operators checked against dense arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lightkrylov_tpu as lk

N = 32


def _rand_mat(dtype, rng, shape=(N, N)):
    A = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.standard_normal(shape)
    return A.astype(dtype)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def test_dense_matvec_rmatvec(dtype, rng):
    A = _rand_mat(dtype, rng)
    x = _rand_mat(dtype, rng, (N,))
    op = lk.DenseOperator(A)
    assert np.allclose(op.matvec(x), A @ x, rtol=1e-4)
    assert np.allclose(op.rmatvec(x), A.conj().T @ x, rtol=1e-4)


def test_autodiff_rmatvec_matches_dense(dtype, rng):
    """Default rmatvec via jax.linear_transpose equals A^H y."""
    A = _rand_mat(dtype, rng)
    x = _rand_mat(dtype, rng, (N,))
    op = lk.MatvecOperator(lambda p, v: p @ v, params=jnp.asarray(A))
    assert np.allclose(op.rmatvec(x), A.conj().T @ x, rtol=1e-4)


def test_adjoint_operator(dtype, rng):
    """(reference: adjoint_linop, AbstractLinops.fypp:89-100,573-599)."""
    A = _rand_mat(dtype, rng)
    x = _rand_mat(dtype, rng, (N,))
    op = lk.DenseOperator(A).H
    assert np.allclose(op.matvec(x), A.conj().T @ x, rtol=1e-4)
    # double adjoint collapses
    assert isinstance(op.H, lk.DenseOperator)


def test_scaled_axpby_composed(dtype, rng):
    """(reference: scaled_linop :153-176, axpby_linop :182-197)."""
    A = _rand_mat(dtype, rng)
    B = _rand_mat(dtype, rng)
    x = _rand_mat(dtype, rng, (N,))
    opA, opB = lk.DenseOperator(A), lk.DenseOperator(B)
    assert np.allclose((2.5 * opA).matvec(x), 2.5 * (A @ x), rtol=1e-4)
    assert np.allclose((opA + opB).matvec(x), (A + B) @ x, rtol=1e-4)
    assert np.allclose((opA - opB).matvec(x), (A - B) @ x, rtol=1e-4)
    assert np.allclose((opA @ opB).matvec(x), A @ (B @ x), rtol=1e-4)
    axpby = lk.AxpbyOperator(2.0, opA, -1.0, opB, transA=True)
    assert np.allclose(axpby.matvec(x), 2.0 * (A.conj().T @ x) - B @ x, rtol=1e-4)


def test_identity_diagonal(dtype, rng):
    x = _rand_mat(dtype, rng, (N,))
    assert np.allclose(lk.IdentityOperator().matvec(x), x)
    d = _rand_mat(dtype, rng, (N,))
    op = lk.DiagonalOperator(jnp.asarray(d))
    assert np.allclose(op.matvec(x), d * x, rtol=1e-4)
    assert np.allclose(op.rmatvec(x), d.conj() * x, rtol=1e-4)


def test_operator_through_jit(dtype, rng):
    """Operators are pytrees: jit over them without retracing per instance."""
    A = _rand_mat(dtype, rng)
    x = _rand_mat(dtype, rng, (N,))

    @jax.jit
    def apply(op, v):
        return op.matvec(v)

    out = apply(lk.DenseOperator(A), x)
    assert np.allclose(out, A @ x, rtol=1e-4)
    out2 = apply(lk.DenseOperator(2 * A), x)  # same trace, new data
    assert np.allclose(out2, 2 * A @ x, rtol=1e-4)


def test_jacobian_operator(rng):
    """Autodiff Jacobian (reference: abstract_jacobian_linop,
    AbstractSystems.fypp:48-54)."""
    A = _rand_mat(np.float64, rng)

    def F(x):
        return A @ x + jnp.sin(x)

    x0 = _rand_mat(np.float64, rng, (N,))
    J = lk.JacobianOperator(F, jnp.asarray(x0))
    v = _rand_mat(np.float64, rng, (N,))
    J_dense = A + np.diag(np.cos(x0))
    assert np.allclose(J.matvec(v), J_dense @ v, rtol=1e-8)
    assert np.allclose(J.rmatvec(v), J_dense.T @ v, rtol=1e-8)


def _poisson_sparse(nx, ny):
    """Independent oracle: -Delta as the Kronecker sum of two 1D second
    differences (row-major (ny, nx) ordering)."""
    import scipy.sparse as sp

    def d2(n):
        h2 = float(n + 1) ** 2
        return sp.diags([-h2, 2.0 * h2, -h2], [-1, 0, 1], shape=(n, n))

    return (sp.kron(sp.eye(ny), d2(nx)) + sp.kron(d2(ny), sp.eye(nx))).tocsr()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["rsp", "rdp"])
@pytest.mark.parametrize("ny,nx", [(64, 32), (50, 32), (33, 17), (64, 256),
                                   (100, 300), (200, 520)])
def test_poisson2d_matvec_matches_assembled(ny, nx, dtype):
    """The fused pad/slice stencil of Poisson2D == the assembled sparse
    Laplacian, on square, odd and wide grids, in f32 and f64."""
    from lightkrylov_tpu.models import Poisson2D

    u = np.random.default_rng(ny + nx).standard_normal((ny, nx))
    y = np.asarray(Poisson2D(nx, ny, dtype=dtype).matvec(
        jnp.asarray(u.astype(dtype))))
    assert y.dtype == np.dtype(dtype)
    ref = (_poisson_sparse(nx, ny) @ u.astype(dtype).astype(np.float64)
           .reshape(-1)).reshape(ny, nx)
    tol = 1e-6 if dtype == np.float32 else 1e-14
    assert np.linalg.norm(y - ref) < tol * np.linalg.norm(ref)


def test_poisson2d_dense_matches_assembled():
    from lightkrylov_tpu.models import Poisson2D

    assert np.allclose(Poisson2D(7, 5).dense(),
                       _poisson_sparse(7, 5).toarray(), rtol=1e-14)
