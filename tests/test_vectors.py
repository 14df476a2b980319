"""Vector and basis algebra tests
(reference test model: test/TestVectors.fypp — vector-space axiom property
tests on random data, plus basis utility checks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lightkrylov_tpu as lk
from lightkrylov_tpu import vectors

N = 128  # reference fixture size (TestUtils.fypp:18 ``test_size = 128``)


def _template(dtype, pytree=False):
    if pytree:
        return {"a": jnp.zeros((N,), dtype), "b": jnp.zeros((4, 8), dtype)}
    return jnp.zeros((N,), dtype)


@pytest.mark.parametrize("pytree", [False, True], ids=["array", "pytree"])
def test_vector_axioms(key, dtype, pytree):
    """8 vector-space axioms on random data
    (reference: AbstractVectors.fypp:733-927)."""
    lk.verify_vector_axioms(key, _template(dtype, pytree), n_trials=100)


def test_dot_conjugate_linearity(key, dtype):
    x = vectors.rand_like(key, _template(dtype))
    y = vectors.rand_like(jax.random.fold_in(key, 1), _template(dtype))
    ref = np.vdot(np.asarray(x), np.asarray(y))
    assert np.allclose(lk.dot(x, y), ref, rtol=1e-5)
    # norm^2 == dot(x, x), real
    n2 = float(lk.norm(x)) ** 2
    assert np.allclose(n2, np.real(np.vdot(np.asarray(x), np.asarray(x))), rtol=1e-5)


def test_innerprod_matches_dense(key, dtype):
    """innerprod(X, y) = X^H y and innerprod(X, Y) = X^H Y
    (reference: AbstractVectors.fypp:659-695)."""
    k, m = 5, 3
    X = vectors.rand_basis(key, vectors.zeros_basis(_template(dtype), k))
    Y = vectors.rand_basis(jax.random.fold_in(key, 7), vectors.zeros_basis(_template(dtype), m))
    y = vectors.get_column(Y, 0)
    Xm = np.asarray(jax.tree_util.tree_leaves(X)[0])
    ref_v = Xm.conj() @ np.asarray(y)
    assert np.allclose(vectors.innerprod(X, y), ref_v, rtol=1e-5)
    ref_m = Xm.conj() @ np.asarray(jax.tree_util.tree_leaves(Y)[0]).T
    assert np.allclose(vectors.innerprod(X, Y), ref_m, rtol=1e-5)


def test_linear_combination(key, dtype):
    """y = X v and Y = X B (reference: AbstractVectors.fypp:571-643).

    Tolerance is dtype-aware: the rank-k update is a VPU mul+reduce whose
    accumulation order differs from numpy's matmul (single-precision
    round-off only)."""
    k, m = 6, 2
    rtol = 1e-4 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-10
    X = vectors.rand_basis(key, vectors.zeros_basis(_template(dtype), k))
    Xm = np.asarray(jax.tree_util.tree_leaves(X)[0])
    v = np.linspace(1, 2, k).astype(dtype)
    out = vectors.linear_combination(X, jnp.asarray(v))
    assert np.allclose(np.asarray(out), v @ Xm, rtol=rtol, atol=rtol)
    B = np.random.default_rng(0).standard_normal((k, m)).astype(dtype)
    out2 = vectors.linear_combination(X, jnp.asarray(B))
    assert np.allclose(np.asarray(jax.tree_util.tree_leaves(out2)[0]),
                       B.T @ Xm, rtol=rtol, atol=rtol)


def test_gram_hermitian(key, dtype):
    X = vectors.rand_basis(key, vectors.zeros_basis(_template(dtype, True), 4))
    G = np.asarray(vectors.gram(X))
    assert np.allclose(G, G.conj().T, rtol=1e-5)


def test_stack_unstack_roundtrip(key, dtype):
    vs = [vectors.rand_like(jax.random.fold_in(key, i), _template(dtype, True)) for i in range(3)]
    X = vectors.stack(vs)
    assert vectors.basis_size(X) == 3
    back = vectors.unstack(X)
    for a, b in zip(vs, back):
        assert float(vectors.norm(vectors.sub(a, b))) == 0.0


def test_get_size(dtype):
    assert lk.get_size(_template(dtype, True)) == N + 32


def test_innerprod_prefix_exactness(key, dtype):
    """Active-prefix chunked projections == full-buffer projections for
    every fill count k, on buffers honoring the zero-column invariant
    (the exactness contract of vectors.innerprod_prefix)."""
    rng = np.random.default_rng(3)
    m, n = 11, 40

    def draw(shape):
        a = rng.standard_normal(shape)
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            a = a + 1j * rng.standard_normal(shape)
        return jnp.asarray(a.astype(dtype))

    y = draw((n,))
    for k in (0, 1, 3, 8, 11):
        X_np = np.zeros((m, n), dtype)
        X_np[:k] = np.asarray(draw((k, n)))
        X = jnp.asarray(X_np)
        full = vectors.innerprod(X, y)
        pre = vectors.innerprod_prefix(X, y, k, chunk=4)
        assert np.allclose(np.asarray(pre), np.asarray(full), atol=1e-6)
        corr_full = vectors.linear_combination(X, full)
        corr_pre = vectors.linear_combination_prefix(X, pre, k, chunk=4)
        assert np.allclose(np.asarray(corr_pre), np.asarray(corr_full),
                           atol=1e-5)
    # traced k inside jit
    import jax

    @jax.jit
    def f(X, y, k):
        return vectors.innerprod_prefix(X, y, k, chunk=4)

    X_np = np.zeros((m, n), dtype)
    X_np[:5] = np.asarray(draw((5, n)))
    X = jnp.asarray(X_np)
    assert np.allclose(np.asarray(f(X, y, jnp.int32(5))),
                       np.asarray(vectors.innerprod(X, y)), atol=1e-6)


def test_prefix_projection_block_case(key):
    """Prefix projections for stacked blocks (block Arnoldi path)."""
    rng = np.random.default_rng(4)
    m, n, p = 9, 32, 3
    X_np = np.zeros((m, n), np.float64)
    X_np[:6] = rng.standard_normal((6, n))
    X = jnp.asarray(X_np)
    Y = jnp.asarray(rng.standard_normal((p, n)))
    full = vectors.innerprod(X, Y)
    pre = vectors.innerprod_prefix(X, Y, 6, chunk=4)
    assert np.allclose(np.asarray(pre), np.asarray(full))
    cf = vectors.linear_combination(X, full)
    cp = vectors.linear_combination_prefix(X, pre, 6, chunk=4)
    for a, b in zip(jax.tree_util.tree_leaves(cp), jax.tree_util.tree_leaves(cf)):
        assert np.allclose(np.asarray(a), np.asarray(b))


def test_reduction_lowering_invariants():
    """Pin the two reduction lowerings (repo invariants):
    1. innerprod contracts at HIGHEST precision (a default f32 matmul may
       round to TF32 on a GPU: ~3 digits lost per CGS pass);
    2. the vector-coefficient linear_combination lowers as a
       multiply+reduce, NOT a dot (one fused full-f32 stream)."""
    X = jnp.zeros((8, 64), jnp.float32)
    y = jnp.zeros((64,), jnp.float32)
    hlo_ip = jax.jit(vectors.innerprod).lower(X, y).as_text()
    assert "precision = [HIGHEST, HIGHEST]" in hlo_ip.replace("<", " ").replace(">", " ") \
        or "HIGHEST" in hlo_ip, "innerprod lost HIGHEST precision"

    v = jnp.zeros((8,), jnp.float32)
    hlo_lc = jax.jit(vectors.linear_combination).lower(X, v).as_text()
    assert "dot_general" not in hlo_lc, \
        "vector linear_combination regressed to a dot lowering"
