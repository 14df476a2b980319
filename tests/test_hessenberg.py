"""On-device Hessenberg eigensolve (utils/hessenberg.py): Francis QR
eigenvalues, inverse-iteration eigenvectors, fused Ritz analysis, and
eigs-driver parity between the host-LAPACK and device projected paths
(reference semantics: projected ``eig`` per Arnoldi step,
IterativeSolvers.fypp:1065; Ritz residuals :1069-1083)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import lightkrylov_tpu as lk
from lightkrylov_tpu import vectors
from lightkrylov_tpu.models import TridiagToeplitz, toeplitz_eigvals
from lightkrylov_tpu.utils.hessenberg import (hessenberg_eigvals,
                                              hessenberg_eigvecs,
                                              hessenberg_ritz)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 40])
def test_eigvals_match_lapack(n, rng):
    H = np.triu(rng.standard_normal((n, n)), -1)
    wr, wi, ok = hessenberg_eigvals(jnp.asarray(H))
    assert bool(ok)
    w = np.sort_complex(np.asarray(wr) + 1j * np.asarray(wi))
    w_ref = np.sort_complex(np.linalg.eigvals(H))
    assert np.max(np.abs(w - w_ref)) < 1e-11 * max(1.0, np.abs(w_ref).max())


def test_eigvals_f32(rng):
    H = np.triu(rng.standard_normal((24, 24)).astype(np.float32), -1)
    wr, wi, ok = hessenberg_eigvals(jnp.asarray(H))
    assert bool(ok)
    w = np.sort_complex(np.asarray(wr) + 1j * np.asarray(wi))
    w_ref = np.sort_complex(np.linalg.eigvals(H.astype(np.float64)))
    assert np.max(np.abs(w - w_ref)) < 1e-4 * np.abs(w_ref).max()


def test_eigvals_non_hessenberg_input(rng):
    # full dense real input: the internal GEHRD-style reduction must handle
    # it (the Krylov-Schur compressed form has a full b row,
    # BaseKrylov.fypp:782-834)
    n = 20
    A = rng.standard_normal((n, n))
    wr, wi, ok = hessenberg_eigvals(jnp.asarray(A))
    assert bool(ok)
    w = np.sort_complex(np.asarray(wr) + 1j * np.asarray(wi))
    w_ref = np.sort_complex(np.linalg.eigvals(A))
    assert np.max(np.abs(w - w_ref)) < 1e-11 * np.abs(w_ref).max()


def test_eigvals_dynamic_keff(rng):
    n = 24
    H = np.triu(rng.standard_normal((n, n)), -1)
    for k in (1, 2, 7, 15, 24):
        wr, wi, ok = hessenberg_eigvals(jnp.asarray(H), k)
        assert bool(ok)
        w = np.sort_complex((np.asarray(wr) + 1j * np.asarray(wi))[:k])
        w_ref = np.sort_complex(np.linalg.eigvals(H[:k, :k]))
        assert np.max(np.abs(w - w_ref)) < 1e-11 * max(
            1.0, np.abs(w_ref).max())
        # inactive slots report exactly zero
        assert np.all(np.asarray(wr)[k:] == 0)


def test_eigvecs_inverse_iteration(rng):
    n = 30
    H = np.triu(rng.standard_normal((n, n)), -1)
    wr, wi, ok = hessenberg_eigvals(jnp.asarray(H))
    Vr, Vi = hessenberg_eigvecs(jnp.asarray(H), wr, wi)
    V = np.asarray(Vr) + 1j * np.asarray(Vi)
    w = np.asarray(wr) + 1j * np.asarray(wi)
    for j in range(n):
        assert np.linalg.norm(H @ V[:, j] - w[j] * V[:, j]) < 1e-10
        assert abs(np.linalg.norm(V[:, j]) - 1.0) < 1e-12


def test_ritz_matches_host(rng):
    # full check-level parity: eigenvalues, residuals, converged count
    kdim = 20
    for k_eff in (3, 9, 20):
        He = np.zeros((kdim + 1, kdim))
        He[:k_eff + 1, :k_eff] = np.triu(
            rng.standard_normal((k_eff + 1, k_eff)), -1)
        tol = 0.5
        wr, wi, res, Vr, Vi, n_conv, ok = hessenberg_ritz(
            jnp.asarray(He), k_eff, tol)
        assert bool(ok)
        Hk = He[:k_eff, :k_eff]
        w_h, V_h = np.linalg.eig(Hk)
        r_h = abs(He[k_eff, k_eff - 1]) * np.abs(V_h[-1, :])
        w_d = (np.asarray(wr) + 1j * np.asarray(wi))[:k_eff]
        r_d = np.asarray(res)[:k_eff]
        assert np.max(np.abs(np.sort_complex(w_d)
                             - np.sort_complex(w_h))) < 1e-10
        assert np.max(np.abs(np.sort(r_d) - np.sort(r_h))) < 1e-10
        assert int(n_conv) == int(np.sum(r_h < tol))
        # device order is modulus-descending (host convention)
        mod = np.abs(w_d)
        assert np.all(np.diff(mod) <= 1e-12)


def test_ritz_invariant_subspace(rng):
    # beta = 0 (invariant subspace): all active residuals exactly zero
    kdim, k_eff = 10, 6
    He = np.zeros((kdim + 1, kdim))
    He[:k_eff, :k_eff] = np.triu(rng.standard_normal((k_eff, k_eff)), -1)
    wr, wi, res, Vr, Vi, n_conv, ok = hessenberg_ritz(
        jnp.asarray(He), k_eff, 1e-12)
    assert bool(ok)
    assert np.all(np.asarray(res)[:k_eff] == 0)
    assert int(n_conv) == k_eff


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_eigs_device_matches_host(dtype, rng):
    """End-to-end: the fused device projected path reproduces the host
    path through restart cycles on the Toeplitz fixture
    (TestIterativeSolvers.fypp:164-176 analogue)."""
    N = 128
    op = TridiagToeplitz(N, 2.0, -1.0, 1.0, dtype=dtype)
    exact = toeplitz_eigvals(N, 2.0, -1.0, 1.0)
    nev, kdim = 6, 32
    tol = 1e-9 if dtype == jnp.float64 else 1e-5
    x0 = vectors.rand_like(jax.random.PRNGKey(1), jnp.zeros(N, dtype))
    results = {}
    for mode in ("host", "device"):
        evals, evecs, res, info, meta = lk.eigs(
            op, nev, x0=x0, kdim=kdim, tolerance=tol,
            options=lk.EigsOptions(projected=mode))
        assert meta.converged
        got = np.asarray(evals)
        for lam in got:
            assert np.min(np.abs(exact - lam)) < 100 * tol
        results[mode] = (got, np.asarray(res), meta.n_iter)
    # same matvec economy to within one sweep's per-step-checking savings
    assert abs(results["host"][2] - results["device"][2]) <= kdim


def test_eigs_device_ritz_vectors(rng):
    """Device-path Ritz vectors actually diagonalize the operator."""
    N = 96
    op = TridiagToeplitz(N, 1.0, 1.0, -1.0, dtype=jnp.float64)
    x0 = vectors.rand_like(jax.random.PRNGKey(2), jnp.zeros(N, jnp.float64))
    evals, evecs, res, info, meta = lk.eigs(
        op, 4, x0=x0, kdim=24, tolerance=1e-9,
        options=lk.EigsOptions(projected="device"))
    assert meta.converged
    A = np.asarray(op.dense()).astype(complex)
    V = np.asarray(evecs)
    w = np.asarray(evals)
    for i in range(4):
        assert np.linalg.norm(A @ V[i] - w[i] * V[i]) < 1e-7


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_eighs_device_matches_host(dtype):
    """Fused on-device Lanczos sweep (projected eigh per step) reproduces
    the host path through thick restarts (eighs.fypp:79-101 semantics)."""
    N = 128
    a, b = 4.0, -1.0
    op = TridiagToeplitz(N, a, b, b, dtype=dtype)
    exact = np.sort(toeplitz_eigvals(N, a, b).real)[::-1]
    nev, kdim = 6, 32
    tol = 1e-9 if dtype == jnp.float64 else 1e-4
    x0 = vectors.rand_like(jax.random.PRNGKey(9), jnp.zeros(N, dtype))
    results = {}
    for mode in ("host", "device"):
        evals, evecs, res, info, meta = lk.eighs(
            op, nev, x0=x0, kdim=kdim, tolerance=tol,
            options=lk.EigsOptions(projected=mode, maxiter=80))
        assert meta.converged
        err = np.max(np.abs(np.asarray(evals) - exact[:nev])
                     / np.abs(exact[:nev]))
        assert err < 10 * tol
        G = np.asarray(vectors.gram(evecs))
        assert np.allclose(G, np.eye(nev), atol=1e-3 if
                           dtype == jnp.float32 else 1e-8)
        results[mode] = np.asarray(evals)
    assert np.max(np.abs(results["host"] - results["device"])) < 100 * tol


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_svds_device_matches_host(dtype, rng):
    """Fused on-device Golub-Kahan sweep (projected SVD per step)
    reproduces the host path (svd_solvers.fypp:80-102 semantics)."""
    m, n = 96, 64
    Am = rng.standard_normal((m, n)).astype(np.dtype(dtype))
    op = lk.DenseOperator(jnp.asarray(Am))
    sref = np.linalg.svd(Am.astype(np.float64), compute_uv=False)
    tol = 1e-10 if dtype == jnp.float64 else 1e-4
    u0 = jnp.asarray(rng.standard_normal(m).astype(np.dtype(dtype)))
    vt = jnp.zeros(n, dtype)
    for mode in ("host", "device"):
        U, S, V, res, info, meta = lk.svds(
            op, 5, u0=u0, v_template=vt, kdim=20, tolerance=tol,
            options=lk.SVDSOptions(projected=mode, maxiter=40))
        assert meta.converged
        serr = np.max(np.abs(np.asarray(S) - sref[:5]) / sref[:5])
        assert serr < 10 * tol
        # triplet residuals ||A v - s u||
        for i in range(5):
            t = np.linalg.norm(Am @ np.asarray(V)[i]
                               - float(S[i]) * np.asarray(U)[i])
            assert t < 1e4 * tol * sref[0]


def test_iram_restart_factorization(rng):
    """On-device IRAM filter restart preserves the Arnoldi identity
    ``A X'[:, :n] = X'[:, :n+1] H'[:n+1, :n]`` exactly, keeps the basis
    orthonormal, and keeps precisely the n largest-modulus Ritz values
    (the reference's median-selector intent,
    IterativeSolvers.fypp:1099-1100)."""
    from lightkrylov_tpu.krylov.arnoldi import arnoldi, initialize_arnoldi
    from lightkrylov_tpu.krylov.krylov_schur import iram_restart, krylov_schur

    N, kdim = 64, 16
    Am = rng.standard_normal((N, N))
    op = lk.DenseOperator(jnp.asarray(Am))
    x0 = jnp.asarray(rng.standard_normal(N))
    X, H = initialize_arnoldi(x0, kdim)
    X, H, _ = arnoldi(op, X, H, kstart=1, kend=kdim)
    Hh = np.asarray(H)

    Xn, Hn, n, ok = iram_restart(X, H, kdim // 2)
    n = int(n)
    assert bool(ok)
    Xn_h, Hn_h = np.asarray(Xn), np.asarray(Hn)
    r = np.linalg.norm(Am @ Xn_h[:n].T - Xn_h[:n + 1].T @ Hn_h[:n + 1, :n])
    assert r < 1e-12 * np.abs(Hh).max()
    G = Xn_h[:n + 1] @ Xn_h[:n + 1].T
    assert np.linalg.norm(G - np.eye(n + 1)) < 1e-12
    # kept Ritz values = n largest-modulus eigenvalues of the old H
    wf = np.sort_complex(np.linalg.eigvals(Hn_h[:n, :n]))
    wH = np.linalg.eigvals(Hh[:kdim, :kdim])
    wH = np.sort_complex(wH[np.argsort(-np.abs(wH))][:n])
    assert np.max(np.abs(wf - wH)) < 1e-12 * np.abs(wH).max()
    # buffer invariant: unfilled columns exactly zero
    assert np.all(Xn_h[n + 1:] == 0)
    assert np.all(Hn_h[:, n:] == 0)


def test_iram_restart_arrow_input_degrades_safely(rng):
    """On the Krylov-Schur ARROW form (full b row, BaseKrylov.fypp:782-834)
    the IRAM restart must NOT filter (the single-residual truncation is
    only exact for Hessenberg input): it reports ``ok = False`` and falls
    back to a pure truncation, which keeps the factorization identity
    exact.  The eigs driver routes arrow cases to the host Krylov-Schur
    path instead (``h_is_hessenberg`` tracking)."""
    from lightkrylov_tpu.krylov.arnoldi import arnoldi, initialize_arnoldi
    from lightkrylov_tpu.krylov.krylov_schur import iram_restart, krylov_schur

    N, kdim = 64, 16
    Am = rng.standard_normal((N, N))
    op = lk.DenseOperator(jnp.asarray(Am))
    x0 = jnp.asarray(rng.standard_normal(N))
    X, H = initialize_arnoldi(x0, kdim)
    X, H, _ = arnoldi(op, X, H, kstart=1, kend=kdim)
    X, H, m = krylov_schur(X, H)          # host: arrow form
    X, H, _ = arnoldi(op, X, H, kstart=m + 1, kend=kdim)  # refill
    Xn, Hn, n, ok = iram_restart(X, H, kdim // 2)
    n = int(n)
    assert not bool(ok)  # no filtering on arrow input
    assert n >= m        # truncation keeps the arrow row inside the block
    Xn_h, Hn_h = np.asarray(Xn), np.asarray(Hn)
    r = np.linalg.norm(Am @ Xn_h[:n].T - Xn_h[:n + 1].T @ Hn_h[:n + 1, :n])
    assert r < 1e-11 * np.abs(np.asarray(H)).max()
    G = Xn_h[:n + 1] @ Xn_h[:n + 1].T
    assert np.linalg.norm(G - np.eye(n + 1)) < 1e-11


def test_device_thick_restart_paths(rng):
    """Small kdim forces thick restarts through the fully on-device
    compression for both eighs and svds (device outputs w/V, um/vm feed
    the restart directly — no host assembly)."""
    N = 96
    op = TridiagToeplitz(N, 4.0, -1.0, -1.0, dtype=jnp.float64)
    exact = np.sort(toeplitz_eigvals(N, 4.0, -1.0).real)[::-1]
    x0 = vectors.rand_like(jax.random.PRNGKey(4), jnp.zeros(N, jnp.float64))
    evals, evecs, res, info, meta = lk.eighs(
        op, 4, x0=x0, kdim=10, tolerance=1e-9,
        options=lk.EigsOptions(projected="device", maxiter=120))
    assert meta.converged and meta.n_iter > 10  # restarts actually ran
    err = np.max(np.abs(np.asarray(evals) - exact[:4]) / exact[:4])
    assert err < 1e-8

    m, n2 = 80, 60
    Am = rng.standard_normal((m, n2))
    ops = lk.DenseOperator(jnp.asarray(Am))
    sref = np.linalg.svd(Am, compute_uv=False)
    u0 = jnp.asarray(rng.standard_normal(m))
    U, S, V, sres, sinfo, smeta = lk.svds(
        ops, 3, u0=u0, v_template=jnp.zeros(n2), kdim=8, tolerance=1e-10,
        options=lk.SVDSOptions(projected="device", maxiter=120))
    assert smeta.converged and smeta.n_iter > 8
    assert np.max(np.abs(np.asarray(S) - sref[:3]) / sref[:3]) < 1e-9


def test_fused_sweep_check_stride(rng):
    """check_every > 1 in device mode strides the in-loop ritz checks
    (skipping the projected solve between checks); converged results must
    match the per-step cadence to solver tolerance."""
    N = 128
    op = TridiagToeplitz(N, 2.0, -1.0, 1.0, dtype=jnp.float64)
    x0 = vectors.rand_like(jax.random.PRNGKey(1), jnp.zeros(N, jnp.float64))
    outs = {}
    for ce in (None, 3):
        evals, evecs, res, info, meta = lk.eigs(
            op, 4, x0=x0, kdim=24, tolerance=1e-9, check_every=ce,
            options=lk.EigsOptions(projected="device", maxiter=100))
        assert meta.converged
        outs[ce] = np.asarray(evals)
    # same eigenvalue SETS (sort order of near-degenerate conjugate pairs
    # is jitter at the real-part noise level)
    for lam in outs[3]:
        assert np.min(np.abs(outs[None] - lam)) < 1e-7
    # eighs stride
    oph = TridiagToeplitz(N, 4.0, -1.0, -1.0, dtype=jnp.float64)
    for ce in (None, 4):
        evals, _, _, _, meta = lk.eighs(
            oph, 4, x0=x0, kdim=24, tolerance=1e-9, check_every=ce,
            options=lk.EigsOptions(projected="device", maxiter=100))
        assert meta.converged


# ---------------------------------------------------------------------------
# Device Schur + ordschur, IRAM failure surfacing, adaptive cadence,
# final f64 recheck
# ---------------------------------------------------------------------------

from lightkrylov_tpu.utils.hessenberg import ordschur_device, schur_real


@pytest.mark.parametrize("n", [2, 5, 12, 24, 40])
def test_schur_real_factorization(n, rng):
    """Device real Schur: H = Z T Z^T with Z orthogonal, T quasi-triangular
    whose every 2x2 block is a complex-conjugate pair (real-pair blocks
    standardized away), eigenvalues matching LAPACK."""
    A = rng.standard_normal((n, n))
    T, Z, wr, wi, ok = schur_real(jnp.asarray(A))
    T, Z = np.asarray(T), np.asarray(Z)
    assert bool(ok)
    assert np.linalg.norm(Z @ T @ Z.T - A) < 1e-12 * max(1, np.linalg.norm(A))
    assert np.linalg.norm(Z.T @ Z - np.eye(n)) < 1e-12
    assert np.all(np.abs(np.tril(T, -2)) == 0)
    sub = np.diag(T, -1)
    for i in range(n - 1):
        if sub[i] != 0:
            blk = T[i:i + 2, i:i + 2]
            disc = ((blk[0, 0] - blk[1, 1]) / 2) ** 2 + blk[0, 1] * blk[1, 0]
            assert disc < 0  # genuine conjugate pair
    w = np.sort_complex(np.asarray(wr) + 1j * np.asarray(wi))
    w_ref = np.sort_complex(np.linalg.eigvals(A))
    assert np.max(np.abs(w - w_ref)) < 1e-10 * max(1.0, np.abs(w_ref).max())


def test_ordschur_device_selected_leading(rng):
    """Device ordschur: the selected eigenvalues end up in the leading
    block (LAPACK TRSEN semantics, Utils.fypp:37-60), the factorization
    stays exact, and pair-consistency is enforced."""
    for n in (6, 13, 24):
        A = rng.standard_normal((n, n))
        T, Z, wr, wi, ok = schur_real(jnp.asarray(A))
        wall = np.asarray(wr) + 1j * np.asarray(wi)
        for _ in range(3):
            mask = rng.random(n) < 0.4
            T2, Z2, sel2, ok2 = ordschur_device(T, Z, jnp.asarray(mask))
            T2, Z2, sel2 = np.asarray(T2), np.asarray(Z2), np.asarray(sel2)
            assert bool(ok2)
            ns = int(sel2.sum())
            assert np.all(sel2[:ns]) and not np.any(sel2[ns:])
            assert np.linalg.norm(Z2 @ T2 @ Z2.T - A) < 1e-12 * np.linalg.norm(A)
            assert np.linalg.norm(Z2.T @ Z2 - np.eye(n)) < 1e-12
            # pair-consistent host mirror of the selection
            m = mask.copy()
            sub = np.diag(np.asarray(T), -1)
            for i in range(n - 1):
                if sub[i] != 0 and (m[i] or m[i + 1]):
                    m[i] = m[i + 1] = True
            wlead = np.sort_complex(np.linalg.eigvals(T2[:ns, :ns]))
            wsel = np.sort_complex(wall[m])
            assert ns == int(m.sum())
            if ns:
                assert np.max(np.abs(wlead - wsel)) < 1e-9


@pytest.mark.parametrize("arrow", [False, True])
def test_krylov_schur_device_matches_host(arrow, rng):
    """Device Krylov-Schur restart (schur_real + ordschur_device) keeps the
    factorization identity/orthonormality exact and the kept Ritz values
    equal to the host LAPACK path's, on both Hessenberg and arrow input
    (BaseKrylov.fypp:714-837)."""
    from lightkrylov_tpu.krylov.arnoldi import arnoldi, initialize_arnoldi
    from lightkrylov_tpu.krylov.krylov_schur import (krylov_schur,
                                                     krylov_schur_device)

    N, kdim = 64, 16
    Am = rng.standard_normal((N, N))
    op = lk.DenseOperator(jnp.asarray(Am))
    x0 = jnp.asarray(rng.standard_normal(N))
    X, H = initialize_arnoldi(x0, kdim)
    X, H, _ = arnoldi(op, X, H, kstart=1, kend=kdim)
    if arrow:
        X, H, m = krylov_schur(X, H)
        X, H, _ = arnoldi(op, X, H, kstart=m + 1, kend=kdim)
        assert np.any(np.tril(np.asarray(H)[:kdim, :kdim], -2) != 0)
    Hh = np.asarray(H)
    w = np.linalg.eigvals(Hh[:kdim, :kdim])
    wsorted = w[np.argsort(-np.abs(w))]
    select = lambda ws: ws.real > np.median(ws.real)  # noqa: E731
    mask = select(wsorted)
    Xn, Hn, n, ok = krylov_schur_device(
        X, H, jnp.asarray(wsorted.real), jnp.asarray(wsorted.imag),
        jnp.asarray(mask))
    n = int(n)
    assert bool(ok)
    Xh, Hnh = np.asarray(Xn), np.asarray(Hn)
    r = np.linalg.norm(Am @ Xh[:n].T - Xh[:n + 1].T @ Hnh[:n + 1, :n])
    assert r < 1e-11 * np.abs(Hh).max()
    G = Xh[:n + 1] @ Xh[:n + 1].T
    assert np.linalg.norm(G - np.eye(n + 1)) < 1e-11
    assert np.all(Xh[n + 1:] == 0) and np.all(Hnh[:, n:] == 0)
    # kept Ritz values match the host path's selection
    X2, H2, n2 = krylov_schur(X, H, select=select)
    assert n2 == n
    wk_dev = np.sort_complex(np.linalg.eigvals(Hnh[:n, :n]))
    wk_host = np.sort_complex(np.linalg.eigvals(np.asarray(H2)[:n2, :n2]))
    assert np.max(np.abs(wk_dev - wk_host)) < 1e-10


def test_eigs_custom_selector_device_no_host_lapack(rng, monkeypatch):
    """eigs with a custom selector in device mode restarts through the
    device Schur path — host LAPACK is never touched —
    and matches the host path's eigenvalues."""
    from lightkrylov_tpu.models import TridiagToeplitz, toeplitz_eigvals
    from lightkrylov_tpu.utils import linalg as _linalg

    N = 128
    op = TridiagToeplitz(N, 2.0, -1.0, 1.0, dtype=jnp.float64)
    exact = toeplitz_eigvals(N, 2.0, -1.0, 1.0)
    x0 = vectors.rand_like(jax.random.PRNGKey(1), jnp.zeros(N, jnp.float64))

    def sel(w):
        m = np.abs(w)
        return m > np.median(m)

    def boom(*a, **k):
        raise AssertionError("host schur_select reached from device path")

    results = {}
    for mode in ("host", "device"):
        if mode == "device":
            monkeypatch.setattr(_linalg, "schur_select", boom)
        evals, evecs, res, info, meta = lk.eigs(
            op, 6, x0=x0, kdim=16, tolerance=1e-9, select=sel,
            options=lk.EigsOptions(projected=mode, maxiter=100))
        monkeypatch.undo()
        assert meta.converged
        for lam in np.asarray(evals):
            assert np.min(np.abs(exact - lam)) < 1e-7
        results[mode] = np.asarray(evals)
    # same eigenvalue SETS (sort order on conjugate pairs is jitter at
    # the real-part noise level)
    for lam in results["device"]:
        assert np.min(np.abs(results["host"] - lam)) < 1e-7


def test_eigs_device_resume_arrow_checkpoint(tmp_path, rng, monkeypatch):
    """Resume from a checkpoint holding the ARROW form: the device driver
    detects it (h_is_hessenberg False) and restarts through the device
    Schur path — no host LAPACK."""
    from lightkrylov_tpu.models import TridiagToeplitz, toeplitz_eigvals
    from lightkrylov_tpu.utils import linalg as _linalg

    N = 128
    op = TridiagToeplitz(N, 2.0, -1.0, 1.0, dtype=jnp.float64)
    exact = toeplitz_eigvals(N, 2.0, -1.0, 1.0)
    x0 = vectors.rand_like(jax.random.PRNGKey(3), jnp.zeros(N, jnp.float64))
    ck = str(tmp_path / "eigs_arrow.npz")

    def sel(w):
        m = np.abs(w)
        return m > np.median(m)

    # host run with a custom selector: every checkpointed restart leaves
    # the arrow form; stop early by maxiter
    lk.eigs(op, 6, x0=x0, kdim=16, tolerance=1e-12, select=sel,
            options=lk.EigsOptions(projected="host", maxiter=3,
                                   checkpoint_every=1, checkpoint_path=ck))
    # arrow form actually captured
    st = np.load(ck)
    hkey = [k for k in st.files if "'H'" in k][0]
    assert np.any(np.tril(st[hkey][:16, :16], -2) != 0)

    def boom(*a, **k):
        raise AssertionError("host schur_select reached on device resume")

    monkeypatch.setattr(_linalg, "schur_select", boom)
    evals, evecs, res, info, meta = lk.eigs(
        op, 6, x0=x0, kdim=16, tolerance=1e-9, select=sel,
        options=lk.EigsOptions(projected="device", maxiter=100),
        resume_from=ck)
    assert meta.converged
    for lam in np.asarray(evals):
        assert np.min(np.abs(exact - lam)) < 1e-7


def test_iram_failure_reroutes_to_schur_restart(rng, monkeypatch):
    """Two consecutive truncation-only IRAM restarts (ok=False) reroute the
    device driver to the Schur-reorder restart path, with a warning per
    failure."""
    import importlib

    eigs_mod = importlib.import_module("lightkrylov_tpu.solvers.eigs")
    from lightkrylov_tpu.models import TridiagToeplitz, toeplitz_eigvals

    N = 128
    op = TridiagToeplitz(N, 2.0, -1.0, 1.0, dtype=jnp.float64)
    exact = toeplitz_eigvals(N, 2.0, -1.0, 1.0)
    x0 = vectors.rand_like(jax.random.PRNGKey(5), jnp.zeros(N, jnp.float64))

    orig = eigs_mod.iram_restart
    calls = {"n": 0}

    def failing_iram(X, H, n_target):
        calls["n"] += 1
        Xn, Hn, n, _ok = orig(X, H, n_target)
        return Xn, Hn, n, jnp.asarray(False)  # filter "failed"

    monkeypatch.setattr(eigs_mod, "iram_restart", failing_iram)
    evals, evecs, res, info, meta = lk.eigs(
        op, 6, x0=x0, kdim=16, tolerance=1e-9,
        options=lk.EigsOptions(projected="device", maxiter=100))
    # the driver stopped trusting IRAM after 2 consecutive failures...
    assert calls["n"] == 2
    # ...and still converged through the Schur restart path
    assert meta.converged
    for lam in np.asarray(evals):
        assert np.min(np.abs(exact - lam)) < 1e-7


def test_adaptive_stride_selection():
    """The adaptive device-check cadence picks a long stride when matvecs
    are cheap relative to the projected solve and per-step checks when the
    matvec dominates."""
    from lightkrylov_tpu.solvers.eigs import _AdaptiveStride

    # cheap matvec (t_step 0.5 ms) vs expensive check (20 ms)
    a = _AdaptiveStride(40, "eigs")
    assert a.next_stride() == a.DEFAULT       # compile cycle
    a.record(99.0, 40, a.DEFAULT)             # discarded (compile)
    s1 = a.next_stride()
    assert s1 == 1
    a.record(40 * (0.0005 + 0.020), 40, s1)   # stride-1 probe
    s2 = a.next_stride()
    assert s2 == 8
    a.record(40 * 0.0005 + 5 * 0.020, 40, s2)  # stride-8 probe
    assert 30 <= a.next_stride() <= 40         # ~t_check/t_step = 40

    # expensive matvec (55 ms) vs 20 ms check -> per-step-ish cadence
    b = _AdaptiveStride(40, "eigs")
    b.record(99.0, 40, b.DEFAULT)
    b.record(40 * (0.055 + 0.020), 40, 1)
    b.record(40 * 0.055 + 5 * 0.020, 40, 8)
    assert b.next_stride() == 1

    # check measured free -> per-step
    c = _AdaptiveStride(40, "eigs")
    c.record(99.0, 40, c.DEFAULT)
    c.record(40 * 0.010, 40, 1)
    c.record(40 * 0.010, 40, 8)
    assert c.next_stride() == 1


def test_final_recheck_sharpens_f32_floor(rng):
    """f32 device path with a tolerance below the f32 projected-residual
    floor (~eps_f32 * sigma_max): without the final f64 host recheck the
    solver reports non-convergence; the recheck settles it."""
    m = 48
    # well-separated spectrum scaled so the f32 projected-residual floor
    # (~eps_f32 * coupling ~ 1e-4) sits well ABOVE the tolerance
    qa, _ = np.linalg.qr(rng.standard_normal((m, m)))
    qb, _ = np.linalg.qr(rng.standard_normal((m, m)))
    s_true = 3e3 * 0.5 ** np.arange(m)
    Am = (qa * s_true) @ qb.T
    op = lk.DenseOperator(jnp.asarray(Am.astype(np.float32)))
    u0 = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    U, S, V, res, info, meta = lk.svds(
        op, 3, u0=u0, kdim=24, tolerance=1e-5,
        options=lk.SVDSOptions(projected="device", maxiter=6))
    assert info > 0 and meta.converged
    assert np.max(np.abs(np.asarray(S) - s_true[:3]) / s_true[0]) < 1e-5
