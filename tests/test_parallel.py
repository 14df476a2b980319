"""Distributed-path tests on the virtual 8-device CPU mesh
(SURVEY.md §4: run the serial suite's checks on a multi-device mesh and
require identical-to-tolerance results — the dimension the reference's
test suite lacks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lightkrylov_tpu as lk
from lightkrylov_tpu import vectors
from lightkrylov_tpu.models import Poisson2D, poisson2d_eigvals
from lightkrylov_tpu.parallel import (
    ShardedPoisson2D,
    distribute,
    make_mesh,
    P,
)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 2, reason="needs the virtual multi-device mesh"
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


def test_sharded_matvec_matches_serial(mesh):
    """Halo-exchange stencil == single-device stencil."""
    nx, ny = 32, 64
    rng = np.random.default_rng(0)
    u = rng.standard_normal((ny, nx))
    serial = Poisson2D(nx, ny)
    sharded = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    ud = distribute(jnp.asarray(u), mesh, P(mesh.axis_names[0], None))
    out_s = np.asarray(serial.matvec(jnp.asarray(u)))
    out_d = np.asarray(jax.jit(sharded.matvec)(ud))
    assert np.allclose(out_s, out_d, atol=1e-12)


def test_sharded_matvec_sharding_preserved(mesh):
    """Output keeps the row sharding (no accidental gather)."""
    sharded = ShardedPoisson2D(32, 64, mesh=mesh, dtype=jnp.float64)
    u = sharded.template()
    out = jax.jit(sharded.matvec)(u)
    assert out.sharding.spec == P(mesh.axis_names[0], None)


def test_dot_on_sharded_vectors(mesh):
    """Batched inner products on sharded bases reduce correctly (single
    fused all-reduce under jit — SURVEY.md §2 item 3)."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((5, 64, 32))
    y = rng.standard_normal((64, 32))
    spec = P(None, mesh.axis_names[0], None)
    Xd = distribute(jnp.asarray(X), mesh, spec)
    yd = distribute(jnp.asarray(y), mesh, P(mesh.axis_names[0], None))
    got = jax.jit(vectors.innerprod)(Xd, yd)
    ref = np.tensordot(X, y, axes=([1, 2], [0, 1]))
    assert np.allclose(np.asarray(got), ref, atol=1e-12)


def test_cg_on_sharded_poisson(mesh):
    """CG on the sharded operator matches the serial solution."""
    nx, ny = 16, 32
    serial = Poisson2D(nx, ny)
    sharded = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((ny, nx))
    bd = distribute(jnp.asarray(b), mesh, P(mesh.axis_names[0], None))
    xs, _, ms = lk.cg(serial, jnp.asarray(b), options=lk.CGOptions(maxiter=400))
    xd, _, md = lk.cg(sharded, bd, options=lk.CGOptions(maxiter=400))
    assert ms.converged and md.converged
    assert np.allclose(np.asarray(xs), np.asarray(xd), atol=1e-8)


def test_gmres_on_sharded_poisson(mesh):
    nx, ny = 16, 32
    sharded = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((ny, nx))
    bd = distribute(jnp.asarray(b), mesh, P(mesh.axis_names[0], None))
    x, info, meta = lk.gmres(sharded, bd,
                             options=lk.GMRESOptions(kdim=30, maxiter=60))
    assert meta.converged
    res = float(lk.norm(lk.sub(sharded.matvec(x), bd))) / float(lk.norm(bd))
    assert res < lk.rtol(np.float64)


def test_eighs_on_sharded_poisson_analytic(mesh):
    """BASELINE config 5 (scaled down): leading Poisson eigenvalues on the
    partitioned operator match the closed form."""
    nx, ny = 16, 32
    sharded = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    exact = np.sort(poisson2d_eigvals(nx, ny))[::-1]
    x0 = distribute(
        jnp.asarray(np.random.default_rng(4).standard_normal((ny, nx))),
        mesh, P(mesh.axis_names[0], None))
    evals, evecs, res, info, meta = lk.eighs(sharded, 4, x0=x0, kdim=200,
                                             tolerance=1e-9)
    assert meta.converged
    err = np.max(np.abs(np.asarray(evals) - exact[:4]) / exact[:4])
    assert err < 1e-8


def _count_allreduce_ops(hlo: str) -> int:
    import re
    # op *definitions* only ("%name = ty all-reduce(..." or all-reduce-start)
    return len(re.findall(r"= \S+ all-reduce(?:-start)?\(", hlo))


def test_innerprod_single_allreduce(mesh):
    """The CGS2 batched projection must lower to a single fused all-reduce
    per pass (SURVEY.md §2 item 3 — the low-synch design target)."""
    rng = np.random.default_rng(7)
    X = distribute(jnp.asarray(rng.standard_normal((9, 64, 32))), mesh,
                   P(None, mesh.axis_names[0], None))
    y = distribute(jnp.asarray(rng.standard_normal((64, 32))), mesh,
                   P(mesh.axis_names[0], None))
    hlo = jax.jit(vectors.innerprod).lower(X, y).compile().as_text()
    n_ar = _count_allreduce_ops(hlo)
    assert n_ar == 1, f"expected one fused all-reduce, found {n_ar}"


def test_gram_single_allreduce(mesh):
    rng = np.random.default_rng(8)
    X = distribute(jnp.asarray(rng.standard_normal((9, 64, 32))), mesh,
                   P(None, mesh.axis_names[0], None))
    hlo = jax.jit(vectors.gram).lower(X).compile().as_text()
    n_ar = _count_allreduce_ops(hlo)
    assert n_ar == 1, f"expected one fused all-reduce, found {n_ar}"


def test_cholqr_pass_single_allreduce(mesh):
    """One CholeskyQR pass = one fused all-reduce on a sharded basis (vs
    the CGS2 column loop's k sequential reductions)."""
    from lightkrylov_tpu.krylov.qr import _cholqr_pass, cholesky_qr2
    from lightkrylov_tpu.krylov import is_orthonormal

    rng = np.random.default_rng(9)
    X = distribute(jnp.asarray(rng.standard_normal((6, 64, 32))), mesh,
                   P(None, mesh.axis_names[0], None))
    hlo = jax.jit(_cholqr_pass).lower(X).compile().as_text()
    n_ar = _count_allreduce_ops(hlo)
    assert n_ar == 1, f"expected one fused all-reduce, found {n_ar}"
    Q, R, info = cholesky_qr2(X)
    assert info == 0 and bool(is_orthonormal(Q))
    # Q keeps the row-partitioned sharding of X
    assert Q.sharding.spec == P(None, mesh.axis_names[0], None)


def test_zeros_basis_propagates_sharding(mesh):
    """Krylov buffers of sharded templates are allocated sharded, not
    replicated (memory-critical at 10M DoF)."""
    x = distribute(jnp.zeros((64, 32)), mesh, P(mesh.axis_names[0], None))
    X = vectors.zeros_basis(x, 5)
    assert X.sharding.spec == P(None, mesh.axis_names[0], None)
    # and the eager Arnoldi init keeps it sharded
    from lightkrylov_tpu.krylov.arnoldi import initialize_arnoldi
    rng = np.random.default_rng(0)
    x0 = distribute(jnp.asarray(rng.standard_normal((64, 32))), mesh,
                    P(mesh.axis_names[0], None))
    Xb, H = initialize_arnoldi(x0, 6)
    assert Xb.sharding.spec[1] == mesh.axis_names[0]


def test_sharded_gl_matches_serial(mesh):
    """1D-partitioned complex GL operator == serial operator."""
    from lightkrylov_tpu.models import GinzburgLandau
    from lightkrylov_tpu.parallel import ShardedGinzburgLandau

    nx = 256
    ser = GinzburgLandau(nx=nx, dtype=jnp.complex128)
    shd = ShardedGinzburgLandau(nx, mesh=mesh, dtype=jnp.complex128)
    rng = np.random.default_rng(5)
    u = rng.standard_normal(nx) + 1j * rng.standard_normal(nx)
    ud = distribute(jnp.asarray(u), mesh, P(mesh.axis_names[0]))
    a = np.asarray(ser.matvec(jnp.asarray(u)))
    b = np.asarray(jax.jit(shd.matvec)(ud))
    assert np.allclose(a, b, atol=1e-12)
    a2 = np.asarray(ser.rmatvec(jnp.asarray(u)))
    b2 = np.asarray(jax.jit(shd.rmatvec)(ud))
    assert np.allclose(a2, b2, atol=1e-12)


@pytest.mark.parametrize("nx,ny", [(32, 64), (32, 256)])
def test_sharded_stencil_f32_matches_serial(mesh, nx, ny):
    """f32 sharded stencil == serial stencil with several local rows per
    device, and the output keeps its row partitioning (no gather)."""
    rng = np.random.default_rng(7)
    u = rng.standard_normal((ny, nx)).astype(np.float32)
    serial = Poisson2D(nx, ny, dtype=jnp.float32)
    sharded = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float32)
    ud = distribute(jnp.asarray(u), mesh, P(mesh.axis_names[0], None))
    out_s = np.asarray(serial.matvec(jnp.asarray(u)))
    out = jax.jit(sharded.matvec)(ud)
    assert np.linalg.norm(out_s - np.asarray(out)) < 1e-6 * np.linalg.norm(out_s)
    assert out.sharding.spec == P(mesh.axis_names[0], None)


def _random_bell(nbr, nbc, width, bm=8, bn=128, seed=0):
    from lightkrylov_tpu.ops import BellMatrix

    rng = np.random.default_rng(seed)
    cols = np.zeros((nbr, width), np.int32)
    for i in range(nbr):
        cols[i] = np.sort(rng.choice(nbc, width, replace=False))
    blocks = rng.standard_normal((nbr, width, bm, bn)).astype(np.float32)
    dense = np.zeros((nbr * bm, nbc * bn), np.float32)
    for i in range(nbr):
        for k in range(width):
            j = cols[i, k]
            dense[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += blocks[i, k]
    bell = BellMatrix(jnp.asarray(blocks), jnp.asarray(cols),
                      (nbr * bm, nbc * bn), nnz=blocks.size)
    return bell, dense


def test_sharded_bell_matvec_matches_dense(mesh):
    """Row-partitioned Block-ELL SpMV (all-gather + local Block-ELL product)
    == dense oracle; output stays row-partitioned."""
    from lightkrylov_tpu.parallel import ShardedBellOperator

    nbr, nbc, width = 64, 4, 3   # 512 x 512, 8 block-rows per device
    bell, dense = _random_bell(nbr, nbc, width, seed=11)
    op = ShardedBellOperator(bell, mesh=mesh)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(512).astype(np.float32)
    xd = distribute(jnp.asarray(x), mesh, P(mesh.axis_names[0]))
    y = np.asarray(jax.jit(op.matvec)(xd))
    yref = dense @ x
    assert np.allclose(y, yref, rtol=1e-4, atol=1e-3 * np.abs(yref).max())
    out = jax.jit(op.matvec)(xd)
    assert out.sharding.spec == P(mesh.axis_names[0])


def test_sharded_bell_rmatvec_matches_dense(mesh):
    """Adjoint of the row-partitioned Block-ELL operator: local transpose
    contributions + one psum."""
    from lightkrylov_tpu.parallel import ShardedBellOperator

    nbr, nbc, width = 64, 4, 3
    bell, dense = _random_bell(nbr, nbc, width, seed=13)
    op = ShardedBellOperator(bell, mesh=mesh)
    rng = np.random.default_rng(14)
    y = rng.standard_normal(512).astype(np.float32)
    yd = distribute(jnp.asarray(y), mesh, P(mesh.axis_names[0]))
    x = np.asarray(jax.jit(op.rmatvec)(yd))
    xref = dense.T @ y
    assert np.allclose(x, xref, rtol=1e-4, atol=1e-3 * np.abs(xref).max())


def test_gmres_on_sharded_bell(mesh):
    """End-to-end: GMRES on the sharded Block-ELL operator (diagonally
    dominated so it converges fast)."""
    from lightkrylov_tpu.ops import BellMatrix
    from lightkrylov_tpu.parallel import ShardedBellOperator

    nbr, nbc, width = 64, 4, 4  # every block column present in every row
    bell, dense = _random_bell(nbr, nbc, width, seed=15)
    # add 50*I to make it well-conditioned: bump the diagonal blocks
    blocks = np.array(bell.data)
    cols = np.array(bell.cols)
    bm, bn = 8, 128
    dense2 = dense + 50.0 * np.eye(512, dtype=np.float32)
    for i in range(nbr):
        jblk = (i * bm) // bn  # block-column containing the diagonal
        k = int(np.where(cols[i] == jblk)[0][0])
        for r in range(bm):
            gc = i * bm + r - jblk * bn
            blocks[i, k, r, gc] += 50.0
    bell2 = BellMatrix(jnp.asarray(blocks), jnp.asarray(cols), (512, 512),
                       nnz=blocks.size)
    op = ShardedBellOperator(bell2, mesh=mesh)
    rng = np.random.default_rng(16)
    b = rng.standard_normal(512).astype(np.float32)
    bd = distribute(jnp.asarray(b), mesh, P(mesh.axis_names[0]))
    x, info, meta = lk.gmres(op, bd, atol=1e-4, rtol=0.0)
    r = dense2 @ np.asarray(x) - b
    assert np.linalg.norm(r) < 1e-3


# -- solver coverage on the mesh beyond cg/gmres/eighs ----


def test_eigs_with_restart_on_sharded_gl(mesh):
    """Non-Hermitian eigs incl. the Krylov-Schur restart path on the
    1D-partitioned complex GL operator: eigenvalues must match the dense
    serial spectrum (an accidental gather or replicated buffer in the
    restart compression would break this)."""
    from lightkrylov_tpu.models import GinzburgLandau
    from lightkrylov_tpu.parallel import ShardedGinzburgLandau

    nx = 128
    shd = ShardedGinzburgLandau(nx, mesh=mesh, dtype=jnp.complex128)
    dense = GinzburgLandau(nx=nx, dtype=jnp.complex128).dense()
    exact = np.linalg.eigvals(dense)
    exact = exact[np.argsort(-np.abs(exact))]

    x0 = shd.template()
    x0 = x0 + (1.0 + 0.5j)  # nonzero seed, keeps sharding
    # small kdim forces at least one Krylov-Schur restart cycle
    evals, evecs, res, info, meta = lk.eigs(shd, nev=3, x0=x0, kdim=10,
                                            tolerance=1e-9)
    assert info > 0
    err = max(np.min(np.abs(l - exact)) for l in np.asarray(evals))
    assert err < 1e-7
    # Ritz vectors keep the distribution
    spec = jax.tree_util.tree_leaves(evecs)[0].sharding.spec
    assert mesh.axis_names[0] in spec


def test_svds_on_sharded_poisson(mesh):
    """svds via Golub-Kahan on the row-partitioned Poisson operator:
    singular values == sorted |eigenvalues| of the SPD operator."""
    from lightkrylov_tpu.models import poisson2d_eigvals

    nx, ny = 16, 32
    op = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    exact = np.sort(poisson2d_eigvals(nx, ny))[::-1]
    rng = np.random.default_rng(20)
    u0 = distribute(jnp.asarray(rng.standard_normal((ny, nx))), mesh,
                    P(mesh.axis_names[0], None))
    U, S, V, res, info, meta = lk.svds(op, nsv=3, u0=u0, kdim=96,
                                       tolerance=1e-10)
    assert info > 0
    assert np.allclose(np.asarray(S), exact[:3], rtol=1e-7)


def test_kexpm_on_sharded_gl(mesh):
    """kexpm on the sharded GL operator vs dense expm oracle."""
    from scipy.linalg import expm as dexpm
    from lightkrylov_tpu.models import GinzburgLandau
    from lightkrylov_tpu.parallel import ShardedGinzburgLandau

    nx = 128
    shd = ShardedGinzburgLandau(nx, mesh=mesh, dtype=jnp.complex128)
    dense = GinzburgLandau(nx=nx, dtype=jnp.complex128).dense()
    rng = np.random.default_rng(21)
    b = rng.standard_normal(nx) + 1j * rng.standard_normal(nx)
    bd = distribute(jnp.asarray(b), mesh, P(mesh.axis_names[0]))
    tau = 0.05
    c, info = lk.kexpm(shd, bd, tau=tau, tol=1e-12, kdim=64)
    cref = dexpm(tau * dense) @ b
    assert np.linalg.norm(np.asarray(c) - cref) < 1e-9 * np.linalg.norm(cref)


def test_newton_on_sharded_reaction_diffusion(mesh):
    """Newton-Krylov on a sharded nonlinear system: steady state of
    -Lap(u) + u^3 = f on the row-partitioned grid (autodiff Jacobian,
    GMRES inner solves — everything rides the mesh)."""
    from lightkrylov_tpu.systems import System

    nx, ny = 16, 32
    A = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    rng = np.random.default_rng(22)
    u_star = distribute(jnp.asarray(rng.standard_normal((ny, nx))), mesh,
                        P(mesh.axis_names[0], None))
    f = A.matvec(u_star) + u_star**3  # manufactured solution

    sys_ = System(lambda u: A.matvec(u) + u**3 - f)
    X0 = distribute(jnp.zeros((ny, nx)), mesh, P(mesh.axis_names[0], None))
    X, info, meta = lk.newton(sys_, X0, rtol=0.0, atol=1e-10)
    assert info > 0
    assert np.linalg.norm(np.asarray(X - u_star)) < 1e-6


def test_checkpoint_roundtrip_sharded(mesh):
    """Arnoldi factorization checkpoint/restore keeps values AND returns a
    usable state on the mesh (resume continues to a valid factorization)."""
    import tempfile, os
    from lightkrylov_tpu.krylov.arnoldi import arnoldi, initialize_arnoldi
    from lightkrylov_tpu.utils.checkpoint import save_checkpoint, load_checkpoint

    nx, ny = 16, 32
    op = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    rng = np.random.default_rng(23)
    x0 = distribute(jnp.asarray(rng.standard_normal((ny, nx))), mesh,
                    P(mesh.axis_names[0], None))
    kdim = 6
    X, H = initialize_arnoldi(x0, kdim)
    X, H, info = arnoldi(op, X, H, kstart=1, kend=3)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        save_checkpoint({"X": X, "H": H}, path)
        state = load_checkpoint({"X": X, "H": H}, path)
    X2, H2 = state["X"], state["H"]
    assert np.allclose(np.asarray(H), np.asarray(H2))
    # resume on the mesh and verify the factorization identity
    X2 = distribute(X2, mesh, P(None, mesh.axis_names[0], None))
    X2, H2, info = arnoldi(op, X2, H2, kstart=4, kend=kdim)
    lead = jax.tree.map(lambda l: l[:kdim], X2)
    AX = jax.vmap(op.matvec)(lead)
    XH = jnp.einsum("iyx,ik->kyx", X2, H2)
    assert np.linalg.norm(np.asarray(AX - XH)) < 1e-10


def test_gmres_large_kdim_prefix_on_sharded(mesh):
    """kdim >= MIN_PREFIX_COLS engages the active-prefix chunked CGS2 on a
    ROW-SHARDED operator: the chunked innerprods/updates must compose with
    GSPMD sharding (per-chunk all-reduces) and match the serial solve."""
    from lightkrylov_tpu.krylov import gram_schmidt
    from lightkrylov_tpu.models import Poisson2D
    from lightkrylov_tpu.parallel import ShardedPoisson2D

    assert 64 >= gram_schmidt.MIN_PREFIX_COLS
    nx, ny = 32, 64
    rng = np.random.default_rng(21)
    b_host = rng.standard_normal((ny, nx)).astype(np.float32)
    op_d = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float32)
    bd = distribute(jnp.asarray(b_host), mesh, P(mesh.axis_names[0], None))
    xd, info_d, _ = lk.gmres(op_d, bd, rtol=1e-6,
                             options=lk.GMRESOptions(kdim=64, maxiter=4))
    op_s = Poisson2D(nx, ny, dtype=jnp.float32)
    xs, info_s, _ = lk.gmres(op_s, jnp.asarray(b_host), rtol=1e-6,
                             options=lk.GMRESOptions(kdim=64, maxiter=4))
    r = np.asarray(op_s.matvec(jnp.asarray(np.asarray(xd)))) - b_host
    assert np.linalg.norm(r) < 1e-4 * np.linalg.norm(b_host)
    assert np.allclose(np.asarray(xd), np.asarray(xs), atol=1e-4)


def test_eighs_checkpoint_resume_sharded(mesh, tmp_path):
    """Checkpoint/resume with a *sharded* operator: load_checkpoint restores
    the saved basis with the template's NamedSharding, and the resumed run
    reproduces the uninterrupted one."""
    nx, ny = 16, 32
    sharded = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    exact = np.sort(poisson2d_eigvals(nx, ny))[::-1]
    x0 = distribute(
        jnp.asarray(np.random.default_rng(4).standard_normal((ny, nx))),
        mesh, P(mesh.axis_names[0], None))
    kw = dict(kdim=24, tolerance=1e-9)

    e_full, _, _, _, m_full = lk.eighs(sharded, 4, x0=x0,
                                       options=lk.EigsOptions(maxiter=80), **kw)
    assert m_full.converged

    path = str(tmp_path / "eighs_sharded.npz")
    _, _, _, _, m_i = lk.eighs(
        sharded, 4, x0=x0, options=lk.EigsOptions(
            maxiter=2, checkpoint_every=1, checkpoint_path=path), **kw)
    assert not m_i.converged

    e_res, evecs, _, _, m_res = lk.eighs(
        sharded, 4, x0=x0, options=lk.EigsOptions(maxiter=80),
        resume_from=path, **kw)
    assert m_res.converged
    assert np.allclose(np.asarray(e_res), np.asarray(e_full), atol=1e-10)
    assert m_res.n_iter == m_full.n_iter
    err = np.max(np.abs(np.asarray(e_res) - exact[:4]) / exact[:4])
    assert err < 1e-8
    # the Ritz vectors keep the mesh sharding through the resume path
    leaf = jax.tree_util.tree_leaves(evecs)[0]
    assert not leaf.sharding.is_fully_replicated


def test_gmres_dcgs2_on_mesh_matches_cgs2(mesh):
    """DCGS2 on the 8-device mesh: same solution as classical CGS2, and
    the delayed scheme's fused measurement keeps the all-reduce count per
    compiled solver strictly below the CGS2 build (one reduction per inner
    iteration vs CGS2's two projection passes + norm)."""
    nx, ny = 32, 64
    sharded = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    rng = np.random.default_rng(12)
    b = distribute(jnp.asarray(rng.standard_normal((ny, nx))), mesh,
                   P(mesh.axis_names[0], None))
    xs, hlos = {}, {}
    from lightkrylov_tpu.solvers.gmres import _gmres_impl
    from lightkrylov_tpu.linops import IdentityOperator
    import lightkrylov_tpu as lk_

    for orth in ("cgs2", "dcgs2"):
        x, info, meta = lk.gmres(
            sharded, b,
            options=lk.GMRESOptions(kdim=20, maxiter=30,
                                    orthogonalization=orth))
        assert meta.converged, orth
        xs[orth] = np.asarray(jax.device_get(x))
        x0 = vectors.zero_like(b)
        tol = jnp.asarray(1e-8)
        hlos[orth] = _gmres_impl.lower(
            sharded, b, x0, IdentityOperator(), tol, 20, 30, False, False,
            True, orth).compile().as_text()
    assert np.allclose(xs["dcgs2"], xs["cgs2"], atol=1e-8)
    n_cgs2 = _count_allreduce_ops(hlos["cgs2"])
    n_dcgs2 = _count_allreduce_ops(hlos["dcgs2"])
    assert n_dcgs2 < n_cgs2, (n_dcgs2, n_cgs2)


def test_device_projected_paths_on_sharded_poisson(mesh):
    """The fused on-device projected eigensolves + device restarts
    (round 4) compose with a row-partitioned operator: the small
    projected problem is replicated, the basis stays sharded, and the
    results match the closed-form spectrum (eigs exercises the IRAM
    device restart via small kdim)."""
    nx, ny = 16, 32
    sharded = ShardedPoisson2D(nx, ny, mesh=mesh, dtype=jnp.float64)
    exact = np.sort(poisson2d_eigvals(nx, ny))[::-1]
    x0 = distribute(
        jnp.asarray(np.random.default_rng(11).standard_normal((ny, nx))),
        mesh, P(mesh.axis_names[0], None))

    # eighs: fused Lanczos sweep + device thick restart
    evals, evecs, res, info, meta = lk.eighs(
        sharded, 4, x0=x0, kdim=24, tolerance=1e-9,
        options=lk.EigsOptions(projected="device", maxiter=200))
    assert meta.converged
    err = np.max(np.abs(np.asarray(evals) - exact[:4]) / exact[:4])
    assert err < 1e-8
    spec = jax.tree_util.tree_leaves(evecs)[0].sharding.spec
    assert mesh.axis_names[0] in spec

    # eigs: fused Arnoldi sweep + IRAM device restart (SPD operator, so
    # the spectrum is known; kdim small enough to force restarts)
    evals2, evecs2, res2, info2, meta2 = lk.eigs(
        sharded, 3, x0=x0, kdim=12, tolerance=1e-8,
        options=lk.EigsOptions(projected="device", maxiter=200))
    assert meta2.converged
    got = np.asarray(evals2).real
    err2 = np.max(np.abs(np.sort(got)[::-1] - exact[:3]) / exact[:3])
    assert err2 < 1e-6
    spec2 = jax.tree_util.tree_leaves(evecs2)[0].sharding.spec
    assert mesh.axis_names[0] in spec2
