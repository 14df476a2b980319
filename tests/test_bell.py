"""Block-ELL sparse operator tests: assembly, products against scipy and a
dense oracle, and solvers running through the operator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import lightkrylov_tpu as lk
from lightkrylov_tpu.models import Poisson2D
from lightkrylov_tpu.ops import BellOperator, bell_from_scipy


def test_bell_from_scipy_roundtrip():
    """Block-ELL assembly reproduces the dense matrix."""
    rng = np.random.default_rng(1)
    A = sp.random(100, 90, density=0.05, random_state=1, format="csr")
    bell = bell_from_scipy(A, bm=8, bn=16, dtype=np.float64)
    nbr, K, bm, bn = bell.data.shape
    dense = np.zeros((nbr * bm, (A.shape[1] + bn - 1) // bn * bn))
    d = np.asarray(bell.data)
    c = np.asarray(bell.cols)
    for i in range(nbr):
        for k in range(K):
            j = c[i, k]
            dense[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += d[i, k]
    assert np.allclose(dense[:100, :90], A.toarray())
    assert bell.nnz == A.nnz


def test_bell_spmv_parity():
    """Block-ELL SpMV == scipy CSR SpMV."""
    A = sp.random(256, 256, density=0.03, random_state=2, format="csr")
    A = A + sp.eye(256)
    bell = bell_from_scipy(A, bm=8, bn=128, dtype=np.float64)
    op = BellOperator(bell)
    x = np.random.default_rng(3).standard_normal(256)
    got = np.asarray(op.matvec(jnp.asarray(x)))
    ref = A @ x
    assert np.allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_bell_rmatvec_parity():
    A = sp.random(256, 256, density=0.03, random_state=4, format="csr")
    bell = bell_from_scipy(A, bm=8, bn=128, dtype=np.float64)
    op = BellOperator(bell)
    y = np.random.default_rng(5).standard_normal(256)
    got = np.asarray(op.rmatvec(jnp.asarray(y)))
    ref = A.T @ y
    assert np.allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_bell_poisson_cg():
    """CG through the Block-ELL operator solves the Poisson system."""
    nx = 16
    dense = Poisson2D(nx).dense()
    A = sp.csr_matrix(dense)
    bell = bell_from_scipy(A, bm=8, bn=128, dtype=np.float64)
    op = BellOperator(bell, is_hermitian=True)
    b = np.random.default_rng(6).standard_normal(nx * nx)
    x, info, meta = lk.cg(op, jnp.asarray(b), options=lk.CGOptions(maxiter=400))
    assert meta.converged
    assert np.linalg.norm(dense @ np.asarray(x) - b) / np.linalg.norm(b) < 1e-7


def test_native_assembler_matches_numpy():
    """C++ Block-ELL assembler produces the identical layout as the numpy
    path (skipped if no compiler)."""
    from lightkrylov_tpu import native

    if not native.available():
        pytest.skip("native assembler unavailable")
    A = sp.random(300, 300, density=0.02, random_state=7, format="csr")
    A = A + sp.eye(300)
    d_nat, c_nat, K = native.bell_assemble(A, 8, 128, np.float64)
    # numpy path: force fallback by requesting complex? instead call the
    # internal path with a complex view of the same matrix
    bell_np = bell_from_scipy(A.astype(np.complex128), bm=8, bn=128,
                              dtype=np.complex128)
    assert K == bell_np.K
    assert np.array_equal(c_nat, np.asarray(bell_np.cols))
    assert np.allclose(d_nat, np.asarray(bell_np.data).real)


def test_native_assembler_timing_smoke():
    """Assembly of a genuinely block-sparse matrix (the format's target:
    multi-dof-per-node PDE operators) is fast.  Note: 1-wide diagonal
    stencils pad catastrophically in Block-ELL (sub-1% fill) — those use
    the dedicated stencil operators instead."""
    from lightkrylov_tpu import native
    if not native.available():
        pytest.skip("native assembler unavailable")
    import time
    rng = np.random.default_rng(11)
    # 4096x4096 with 3 dense 8x128 blocks per block row (~1.5M nnz, fill=1)
    nbr, K_true, bm, bn = 512, 3, 8, 128
    rows, cols_, vals = [], [], []
    for i in range(nbr):
        for j in rng.choice(nbr // 4, K_true, replace=False):
            r0, c0 = i * bm, int(j) * bn
            blk = rng.standard_normal((bm, bn))
            rr, cc = np.meshgrid(np.arange(bm), np.arange(bn), indexing="ij")
            rows.append((r0 + rr).ravel()); cols_.append((c0 + cc).ravel())
            vals.append(blk.ravel())
    A = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols_))),
        shape=(nbr * bm, (nbr // 4) * bn))
    t0 = time.perf_counter()
    data, cols, K = native.bell_assemble(A, bm, bn, np.float32)
    dt = time.perf_counter() - t0
    assert dt < 5.0
    assert K == K_true
    assert data.shape[0] == nbr


_BLOCKS = [(8, 128), (4, 16), (16, 32)]
_DT = [np.float32, np.float64, np.complex64, np.complex128]


def _random_sparse(n, dtype, seed):
    A = sp.random(n, n, density=0.03, random_state=seed, format="csr")
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * sp.random(n, n, density=0.03, random_state=seed + 1,
                               format="csr")
    return (A + sp.eye(n)).astype(dtype)


@pytest.mark.parametrize("dtype", _DT, ids=["rsp", "rdp", "csp", "cdp"])
@pytest.mark.parametrize("bm,bn", _BLOCKS)
def test_bell_products_match_scipy(bm, bn, dtype):
    """matvec and rmatvec of the XLA Block-ELL path == scipy, across block
    shapes (padded edges included: 200 is no multiple of bn) and all four
    dtypes.  f32 products run at HIGHEST precision, so single precision
    agrees to a few ulps of the row sums."""
    n = 200
    A = _random_sparse(n, dtype, seed=bm + bn)
    op = BellOperator(bell_from_scipy(A, bm=bm, bn=bn, dtype=dtype))
    rng = np.random.default_rng(9)
    x = rng.standard_normal(n).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(n).astype(dtype)
    tol = 1e-5 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-12
    Ad = A.astype(np.complex128).toarray()
    y = np.asarray(op.matvec(jnp.asarray(x)))
    assert y.dtype == np.dtype(dtype)
    assert np.linalg.norm(y - Ad @ x) < tol * np.linalg.norm(Ad @ x)
    z = np.asarray(op.rmatvec(jnp.asarray(x)))
    zref = Ad.conj().T @ x
    assert np.linalg.norm(z - zref) < tol * np.linalg.norm(zref)
