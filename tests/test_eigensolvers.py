"""Eigen/SVD solver tests — analytical-spectrum checks
(reference model: test/TestIterativeSolvers.fypp:135-511 — eigs on
tridiagonal Toeplitz with closed-form complex eigenvalues, eighs on SPD
Toeplitz with lambda_i = a + 2|b| cos(i pi/(n+1)) plus eigenvector residual
and V^H V = I, svds analogous)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lightkrylov_tpu as lk
from lightkrylov_tpu import vectors
from lightkrylov_tpu.models import TridiagToeplitz, toeplitz_eigvals

N = 128  # test_size (reference: TestUtils.fypp:18)


def _tol(dtype):
    return lk.rtol(dtype)


def test_eigs_toeplitz_analytic(dtype_dp):
    """eigs on tridiagonal Toeplitz vs closed-form spectrum
    (reference: TestIterativeSolvers.fypp:135-225)."""
    dtype = dtype_dp
    # Skew-symmetric off-diagonals (b upper, -b lower): a *normal* operator
    # with eigenvalues a +- 2bi cos(k pi/(n+1)), exactly the reference's
    # real-eigs fixture (TestIterativeSolvers.fypp:164-176).
    a_, b_ = 2.0, 1.0
    op = TridiagToeplitz(N, a_, -b_, b_, dtype=dtype)
    exact = toeplitz_eigvals(N, a_, -b_, b_)
    exact = exact[np.argsort(-np.abs(exact))]
    nev, kdim = 6, 32
    x0 = vectors.rand_like(jax.random.PRNGKey(1), jnp.zeros(N, dtype))
    evals, evecs, res, info, meta = lk.eigs(op, nev, x0=x0, kdim=kdim,
                                            tolerance=1e-9)
    assert meta.converged, f"eigs did not converge: {res}"
    got = np.asarray(evals)
    for lam in got:
        assert np.min(np.abs(exact - lam) / np.abs(lam)) < 1e-8
    # Ritz residuals: ||A v - lambda v|| small
    A = op.dense().astype(complex)
    for i in range(nev):
        v = np.asarray(vectors.get_column(evecs, i))
        lam = complex(evals[i])
        assert np.linalg.norm(A @ v - lam * v) < 1e-6


def test_eigs_complex_spectrum(dtype_dp):
    """b*c < 0 -> genuinely complex eigenvalues of a real operator
    (conjugate-pair handling, reference: IterativeSolvers.fypp:1073-1083)."""
    dtype = dtype_dp
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        pytest.skip("exercise the real-operator complex-pair path")
    op = TridiagToeplitz(N, 1.0, 1.0, -1.0, dtype=dtype)
    exact = toeplitz_eigvals(N, 1.0, 1.0, -1.0)
    exact = exact[np.argsort(-np.abs(exact))]
    nev, kdim = 4, 32
    x0 = vectors.rand_like(jax.random.PRNGKey(2), jnp.zeros(N, dtype))
    evals, evecs, res, info, meta = lk.eigs(op, nev, x0=x0, kdim=kdim,
                                            tolerance=1e-9)
    assert meta.converged
    got = np.asarray(evals)
    for lam in got:
        assert np.min(np.abs(exact - lam)) < 1e-8
    # eigenvalues of a real operator come in conjugate pairs
    for lam in got:
        if abs(lam.imag) > 1e-10:
            assert np.min(np.abs(got - np.conj(lam))) < 1e-8


def _rotation_spectrum_op(dtype, seed=0):
    """Real operator with conjugate-pair spectrum r_i e^{+-i theta_i},
    moduli decaying geometrically — the restart-friendly fixture."""
    rng = np.random.default_rng(seed)
    n_pairs = N // 2
    r = 2.0 * 0.7 ** np.arange(n_pairs)
    theta = rng.uniform(0.2, np.pi - 0.2, n_pairs)
    blocks = []
    for ri, ti in zip(r, theta):
        blocks.append(ri * np.array([[np.cos(ti), -np.sin(ti)],
                                     [np.sin(ti), np.cos(ti)]]))
    A = np.zeros((N, N))
    for i, Bk in enumerate(blocks):
        A[2 * i:2 * i + 2, 2 * i:2 * i + 2] = Bk
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    A = Q @ A @ Q.T
    exact = np.concatenate([r * np.exp(1j * theta), r * np.exp(-1j * theta)])
    exact = exact[np.argsort(-np.abs(exact))]
    return lk.DenseOperator(jnp.asarray(A.astype(dtype))), exact


def test_eigs_restart_path(dtype_dp):
    """Krylov-Schur restart engages with small kdim and still converges
    (reference: IterativeSolvers.fypp:1099-1100)."""
    dtype = dtype_dp
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        pytest.skip("real-operator restart fixture")
    op, exact = _rotation_spectrum_op(dtype)
    nev, kdim = 4, 12  # small kdim forces restarts
    x0 = vectors.rand_like(jax.random.PRNGKey(3), jnp.zeros(N, dtype))
    evals, evecs, res, info, meta = lk.eigs(
        op, nev, x0=x0, kdim=kdim, tolerance=1e-9,
        options=lk.EigsOptions(maxiter=60))
    assert meta.converged
    got = np.asarray(evals)
    for lam in got:
        assert np.min(np.abs(exact - lam) / np.abs(lam)) < 1e-8


def test_eigs_check_every(dtype_dp):
    """Per-step convergence checking (reference cadence) agrees with the
    batched default."""
    dtype = dtype_dp
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        pytest.skip("real-operator fixture")
    op, _ = _rotation_spectrum_op(dtype)
    x0 = vectors.rand_like(jax.random.PRNGKey(4), jnp.zeros(N, dtype))
    e1, _, _, _, m1 = lk.eigs(op, 4, x0=x0, kdim=24, tolerance=1e-9)
    e2, _, _, _, m2 = lk.eigs(op, 4, x0=x0, kdim=24, tolerance=1e-9,
                              check_every=1)
    assert m1.converged and m2.converged
    assert np.allclose(np.asarray(e1), np.asarray(e2), atol=1e-8)
    assert m2.n_iter <= m1.n_iter  # early exit saves matvecs


def test_eighs_spd_toeplitz(dtype):
    """eighs on SPD Toeplitz: closed-form lambda_i = a + 2|b| cos(i pi/(n+1)),
    eigenvector residual, V^H V = I
    (reference: TestIterativeSolvers.fypp:228-310)."""
    a, b = 4.0, -1.0
    op = TridiagToeplitz(N, a, b, b, dtype=dtype)
    assert op.is_hermitian
    exact = np.sort(toeplitz_eigvals(N, a, b).real)[::-1]
    # the reference allocates a full-size basis for this test (X(test_size));
    # with clustered leading eigenvalues Lanczos needs the large subspace
    nev, kdim = 6, N
    x0 = vectors.rand_like(jax.random.PRNGKey(5), jnp.zeros(N, dtype))
    tol = _tol(dtype)
    evals, evecs, res, info, meta = lk.eighs(op, nev, x0=x0, kdim=kdim,
                                             tolerance=tol)
    assert meta.converged
    err = np.max(np.abs(np.asarray(evals) - exact[:nev]) / np.abs(exact[:nev]))
    assert err < tol
    # orthonormal eigenvectors
    G = np.asarray(vectors.gram(evecs))
    assert np.allclose(G, np.eye(nev), atol=100 * tol)
    # eigenvector residuals
    A = op.dense()
    for i in range(nev):
        v = np.asarray(vectors.get_column(evecs, i))
        assert np.linalg.norm(A @ v - float(evals[i]) * v) < 100 * tol


def test_svds_rectangular(dtype_dp):
    """svds on a rectangular dense operator vs numpy SVD
    (reference: TestIterativeSolvers.fypp:405-511)."""
    dtype = dtype_dp
    rng = np.random.default_rng(17)
    m, n = N, N // 2
    A = rng.standard_normal((m, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.standard_normal((m, n))
    A = A.astype(dtype)
    exact = np.linalg.svd(A, compute_uv=False)
    nsv, kdim = 4, n  # full-size basis (dense singular values cluster)
    u0 = vectors.rand_like(jax.random.PRNGKey(6), jnp.zeros(m, dtype))
    U, S, V, res, info, meta = lk.svds(
        lk.DenseOperator(jnp.asarray(A)), nsv, u0=u0,
        v_template=jnp.zeros(n, dtype), kdim=kdim, tolerance=1e-9)
    assert meta.converged
    assert np.allclose(np.asarray(S), exact[:nsv], rtol=1e-9)
    # A v = s u triplet check + orthonormality
    for i in range(nsv):
        u = np.asarray(vectors.get_column(U, i))
        v = np.asarray(vectors.get_column(V, i))
        assert np.linalg.norm(A @ v - float(S[i]) * u) < 1e-7
    assert np.allclose(np.asarray(vectors.gram(U)), np.eye(nsv), atol=1e-8)
    assert np.allclose(np.asarray(vectors.gram(V)), np.eye(nsv), atol=1e-8)


def test_save_eigenspectrum(tmp_path, dtype_dp):
    """(reference: save_eigenspectrum, IterativeSolvers.fypp:944-963)."""
    evals = jnp.asarray(np.array([1 + 2j, 3 - 4j]))
    res = jnp.asarray(np.array([1e-12, 1e-11]))
    path = str(tmp_path / "spec.npy")
    lk.save_eigenspectrum(evals, res, path)
    out = np.load(path)
    assert out.shape == (2, 3)
    assert np.allclose(out[:, 0], [1, 3])
    assert np.allclose(out[:, 1], [2, -4])


def test_eighs_thick_restart(dtype_dp):
    """Thick-restart Lanczos converges with kdim << the no-restart
    requirement (capability beyond the reference, which notes restart as
    WIP — IterativeSolvers.fypp:743-746)."""
    dtype = dtype_dp
    a, b = 4.0, -1.0
    op = TridiagToeplitz(N, a, b, b, dtype=dtype)
    exact = np.sort(toeplitz_eigvals(N, a, b).real)[::-1]
    x0 = vectors.rand_like(jax.random.PRNGKey(9), jnp.zeros(N, dtype))
    evals, evecs, res, info, meta = lk.eighs(
        op, 6, x0=x0, kdim=32, tolerance=1e-9,
        options=lk.EigsOptions(maxiter=80))
    assert meta.converged
    err = np.max(np.abs(np.asarray(evals) - exact[:6]) / np.abs(exact[:6]))
    assert err < 1e-9
    G = np.asarray(vectors.gram(evecs))
    assert np.allclose(G, np.eye(6), atol=1e-8)


def test_eigs_restart_complex_operator():
    """Krylov-Schur restart on a complex normal operator with geometric
    spectrum (complex Schur path of the restart, cdp flavor)."""
    rng = np.random.default_rng(21)
    r = 2.0 * 0.7 ** np.arange(N)
    theta = rng.uniform(0, 2 * np.pi, N)
    d = r * np.exp(1j * theta)
    Qm, _ = np.linalg.qr(rng.standard_normal((N, N))
                         + 1j * rng.standard_normal((N, N)))
    A = (Qm * d) @ Qm.conj().T
    op = lk.DenseOperator(jnp.asarray(A))
    x0 = vectors.rand_like(jax.random.PRNGKey(13), jnp.zeros(N, np.complex128))
    evals, evecs, res, info, meta = lk.eigs(
        op, 4, x0=x0, kdim=12, tolerance=1e-9,
        options=lk.EigsOptions(maxiter=60))
    assert meta.converged
    exact = d[np.argsort(-np.abs(d))]
    for lam in np.asarray(evals):
        assert np.min(np.abs(exact - lam) / np.abs(lam)) < 1e-8


def test_svds_thick_restart(dtype_dp):
    """Thick-restart Golub-Kahan converges with small kdim (capability
    beyond the reference, IterativeSolvers.fypp:655-658)."""
    dtype = dtype_dp
    rng = np.random.default_rng(31)
    m, n = N, N // 2
    # geometric singular spectrum: restart-friendly
    sv = 3.0 * 0.8 ** np.arange(n)
    Um, _ = np.linalg.qr(rng.standard_normal((m, n)))
    Vm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Um * sv) @ Vm.T
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        Qp = np.exp(1j * rng.uniform(0, 2 * np.pi, n))
        A = A.astype(complex) * Qp[None, :]
    A = A.astype(dtype)
    u0 = vectors.rand_like(jax.random.PRNGKey(6), jnp.zeros(m, dtype))
    U, S, V, res, info, meta = lk.svds(
        lk.DenseOperator(jnp.asarray(A)), 4, u0=u0,
        v_template=jnp.zeros(n, dtype), kdim=12, tolerance=1e-9,
        options=lk.SVDSOptions(maxiter=40))
    assert meta.converged
    assert np.allclose(np.asarray(S), sv[:4], rtol=1e-8)
    for i in range(4):
        u = np.asarray(vectors.get_column(U, i))
        v = np.asarray(vectors.get_column(V, i))
        assert np.linalg.norm(A @ v - float(S[i]) * u) < 1e-7


# -- driver-integrated checkpoint / resume ----------------

def test_eigs_checkpoint_resume(tmp_path, dtype_dp):
    """Interrupt-at-cycle-c + resume reproduces the uninterrupted run: the
    checkpoint stores (X, H, kstart, cycle, niter) at restart boundaries
    and resume_from continues the identical trajectory (the serialization
    the reference lacks — its restart algebra at BaseKrylov.fypp:714-837
    is matched, persistence is new)."""
    dtype = dtype_dp
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        pytest.skip("real-operator restart fixture")
    op, exact = _rotation_spectrum_op(dtype)
    nev, kdim = 4, 12
    x0 = vectors.rand_like(jax.random.PRNGKey(3), jnp.zeros(N, dtype))

    e_full, _, _, _, m_full = lk.eigs(
        op, nev, x0=x0, kdim=kdim, tolerance=1e-9,
        options=lk.EigsOptions(maxiter=60))
    assert m_full.converged

    path = str(tmp_path / "eigs_ckpt.npz")
    opts_i = lk.EigsOptions(maxiter=2, checkpoint_every=1,
                            checkpoint_path=path)
    _, _, _, info_i, m_i = lk.eigs(op, nev, x0=x0, kdim=kdim,
                                   tolerance=1e-9, options=opts_i)
    assert not m_i.converged  # genuinely interrupted mid-run
    import os
    assert os.path.exists(path)

    e_res, _, _, _, m_res = lk.eigs(
        op, nev, x0=x0, kdim=kdim, tolerance=1e-9,
        options=lk.EigsOptions(maxiter=60), resume_from=path)
    assert m_res.converged
    assert np.allclose(np.asarray(e_res), np.asarray(e_full), atol=1e-10)
    # niter is restored cumulatively, so equality proves the resumed run
    # reproduced the uninterrupted trajectory step for step
    assert m_res.n_iter == m_full.n_iter


def test_eighs_checkpoint_resume(tmp_path, dtype_dp):
    dtype = dtype_dp
    a, b = 4.0, -1.0
    op = TridiagToeplitz(N, a, b, b, dtype=dtype)
    x0 = vectors.rand_like(jax.random.PRNGKey(9), jnp.zeros(N, dtype))
    kw = dict(kdim=32, tolerance=1e-9)

    e_full, _, _, _, m_full = lk.eighs(op, 6, x0=x0,
                                       options=lk.EigsOptions(maxiter=80), **kw)
    assert m_full.converged
    path = str(tmp_path / "eighs_ckpt.npz")
    _, _, _, _, m_i = lk.eighs(
        op, 6, x0=x0, options=lk.EigsOptions(
            maxiter=2, checkpoint_every=1, checkpoint_path=path), **kw)
    assert not m_i.converged
    e_res, _, _, _, m_res = lk.eighs(op, 6, x0=x0,
                                     options=lk.EigsOptions(maxiter=80),
                                     resume_from=path, **kw)
    assert m_res.converged
    assert np.allclose(np.asarray(e_res), np.asarray(e_full), atol=1e-10)
    assert m_res.n_iter == m_full.n_iter


def test_svds_checkpoint_resume(tmp_path):
    rng = np.random.default_rng(31)
    m, n = N, N // 2
    sv = 3.0 * 0.8 ** np.arange(n)
    Um, _ = np.linalg.qr(rng.standard_normal((m, n)))
    Vm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = ((Um * sv) @ Vm.T).astype(np.float64)
    op = lk.DenseOperator(jnp.asarray(A))
    u0 = vectors.rand_like(jax.random.PRNGKey(6), jnp.zeros(m, np.float64))
    kw = dict(u0=u0, v_template=jnp.zeros(n, np.float64), kdim=12,
              tolerance=1e-9)

    _, S_full, _, _, _, m_full = lk.svds(op, 4, options=lk.SVDSOptions(maxiter=40), **kw)
    assert m_full.converged
    path = str(tmp_path / "svds_ckpt.npz")
    # maxiter=1 has no restart boundary; mid-cycle sweep boundaries from
    # check_every=4 carry the saves instead (kstart mid-cycle in the state)
    _, _, _, _, _, m_i = lk.svds(
        op, 4, options=lk.SVDSOptions(maxiter=1, checkpoint_every=1,
                                      checkpoint_path=path),
        check_every=4, **kw)
    assert not m_i.converged
    _, S_res, _, _, _, m_res = lk.svds(
        op, 4, options=lk.SVDSOptions(maxiter=40), resume_from=path, **kw)
    assert m_res.converged
    assert np.allclose(np.asarray(S_res), np.asarray(S_full), atol=1e-10)
    assert m_res.n_iter == m_full.n_iter


@pytest.mark.parametrize("mode,symmetric,platform,dt,expected", [
    ("auto", True, "gpu", np.float32, True),
    ("auto", True, "gpu", np.float64, True),
    ("auto", True, "cpu", np.float64, False),
    ("auto", False, "gpu", np.float64, False),
    ("auto", False, "cpu", np.float32, False),
    ("auto", True, "gpu", np.complex128, False),
    ("device", False, "cpu", np.float64, True),
    ("host", True, "gpu", np.float64, False),
    ("device", True, "gpu", np.complex64, False),
])
def test_device_projected_rule(mode, symmetric, platform, dt, expected):
    """``projected="auto"`` takes the device path for the symmetric
    problems of eighs/svds on any accelerator and the host path on the CPU;
    eigs' non-symmetric problem is host everywhere; explicit modes win;
    complex is always host."""
    from lightkrylov_tpu.solvers.eigs import _device_projected

    opts = lk.EigsOptions(projected=mode)
    assert _device_projected(opts, dt, symmetric, platform=platform) is expected
