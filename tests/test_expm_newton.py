"""kexpm oracle tests and Newton-Krylov end-to-end
(reference model: test/TestExpmlib.fypp:42-230 kexpm vs dense expm;
test/TestNewtonKrylov.fypp:46-109 Newton on Roessler from the origin
converges to the analytical fixed point, with and without bisection)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

import lightkrylov_tpu as lk
from lightkrylov_tpu import vectors
from lightkrylov_tpu.models import roessler_fixed_points, fixed_point_system, upo_system

N = 128


def _rand(dtype, rng, shape):
    A = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        A = A + 1j * rng.standard_normal(shape)
    return A.astype(dtype)


@pytest.fixture
def rng():
    return np.random.default_rng(23)


def test_kexpm_vs_dense(dtype, rng):
    """c = exp(tau A) b vs scipy dense expm
    (reference: TestExpmlib.fypp:42-230)."""
    dtype_np = np.dtype(dtype)
    A = (_rand(dtype, rng, (N, N)) / np.sqrt(N)).astype(dtype)
    b = _rand(dtype, rng, (N,))
    tau = 0.7
    tol = lk.rtol(dtype) * 1e-2 if dtype_np.itemsize > 8 or dtype_np == np.float64 else lk.rtol(dtype)
    c, info = lk.kexpm(jnp.asarray(A), jnp.asarray(b), tau, tol=tol, kdim=80)
    assert info > 0 or info == -2
    exact = sla.expm(tau * A) @ b
    err = np.linalg.norm(np.asarray(c) - exact) / np.linalg.norm(exact)
    assert err < 100 * lk.rtol(dtype)


def test_kexpm_invariant_subspace(rng):
    """Breakdown -> exact result, info = -2 (reference: ExpmLib.fypp:200-204)."""
    A = np.zeros((N, N))
    A[:3, :3] = rng.standard_normal((3, 3))
    b = np.zeros(N)
    b[:3] = rng.standard_normal(3)
    c, info = lk.kexpm(jnp.asarray(A), jnp.asarray(b), 1.0, tol=1e-12, kdim=30)
    assert info == -2
    exact = sla.expm(A) @ b
    assert np.linalg.norm(np.asarray(c) - exact) / np.linalg.norm(exact) < 1e-10


def test_krylov_exptA_matches_kexpm(dtype_dp, rng):
    """(reference: krylov_exptA wrapper, ExpmLib.fypp:365-392)."""
    dtype = dtype_dp
    A = (_rand(dtype, rng, (N, N)) / np.sqrt(N)).astype(dtype)
    b = _rand(dtype, rng, (N,))
    c = lk.krylov_exptA(jnp.asarray(A), jnp.asarray(b), 0.3, kdim=60)
    exact = sla.expm(0.3 * A) @ b
    assert np.linalg.norm(np.asarray(c) - exact) / np.linalg.norm(exact) < 1e-9


def test_exponential_propagator_operator(rng):
    """ExponentialPropagator as a LinearOperator: exp(tau A) action and its
    adjoint exp(tau A^H) (reference: abstract_exptA_linop)."""
    dtype = np.float64
    A = (_rand(dtype, rng, (N, N)) / np.sqrt(N)).astype(dtype)
    P = lk.ExponentialPropagator(jnp.asarray(A), 0.5, kdim=60)
    x = _rand(dtype, rng, (N,))
    assert np.allclose(np.asarray(P.matvec(jnp.asarray(x))),
                       sla.expm(0.5 * A) @ x, rtol=1e-8, atol=1e-9)
    assert np.allclose(np.asarray(P.rmatvec(jnp.asarray(x))),
                       sla.expm(0.5 * A.T) @ x, rtol=1e-8, atol=1e-9)


# -- Newton-Krylov -----------------------------------------------------------

def test_newton_roessler_fixed_point():
    """Newton from near the origin converges to the analytical fixed point
    (reference: TestNewtonKrylov.fypp:46-109)."""
    sys = fixed_point_system()
    fp_minus, _ = roessler_fixed_points()
    X0 = jnp.asarray(np.array([0.0, -1.0, 0.1]))
    X, info, meta = lk.newton(sys, X0, rtol=0.0, atol=1e-12)
    assert meta.converged and info > 0
    assert np.allclose(np.asarray(X), fp_minus, atol=1e-9)


def test_newton_roessler_with_bisection():
    """Same, with the golden-section bisection line search enabled
    (reference: TestNewtonKrylov.fypp second variant)."""
    sys = fixed_point_system()
    fp_minus, _ = roessler_fixed_points()
    X0 = jnp.asarray(np.array([0.0, -1.0, 0.1]))
    opts = lk.NewtonOptions(ifbisect=True, maxstep_bisection=5)
    X, info, meta = lk.newton(sys, X0, rtol=0.0, atol=1e-12, options=opts)
    assert meta.converged
    assert np.allclose(np.asarray(X), fp_minus, atol=1e-9)


def test_newton_bisection_eval_accounting():
    """Every system.eval — including the golden-section bisection probes —
    appears in both the operator counters and the metadata's per-eval
    (residual, tolerance) record (reference: NewtonKrylov.fypp:44-65,221-242
    logs every sys%eval with its tolerance; bisection evals at :422-525)."""
    from lightkrylov_tpu.utils import timer

    sys = fixed_point_system()
    X0 = jnp.asarray(np.array([0.0, -1.0, 0.1]))

    timer.reset_counters()
    opts = lk.NewtonOptions(ifbisect=False)
    _, _, meta_plain = lk.newton(sys, X0, rtol=0.0, atol=1e-12, options=opts)
    label = timer.operator_label(sys)
    n_plain = timer.get_counter(f"{label}.eval")
    assert n_plain == meta_plain.n_evals == len(meta_plain.residuals) \
        == len(meta_plain.tolerances)

    timer.reset_counters()
    opts = lk.NewtonOptions(ifbisect=True, maxstep_bisection=5)
    _, _, meta = lk.newton(sys, X0, rtol=0.0, atol=1e-12, options=opts)
    label = timer.operator_label(sys)
    n_bisect = timer.get_counter(f"{label}.eval")
    assert n_bisect == meta.n_evals == len(meta.residuals) \
        == len(meta.tolerances)
    # the bisection probes (maxstep per Newton step) must be visible
    assert n_bisect >= meta.n_iter * 5
    # each eval's tolerance is recorded alongside its residual
    assert np.all(meta.tolerances > 0)


def test_newton_schedulers():
    """constant_tol vs dynamic_tol schedulers both converge
    (reference: NewtonKrylov.fypp:534-598)."""
    sys = fixed_point_system()
    fp_minus, _ = roessler_fixed_points()
    X0 = jnp.asarray(np.array([0.0, -1.0, 0.1]))
    for sched in (lk.constant_tol, lk.dynamic_tol):
        X, info, meta = lk.newton(sys, X0, rtol=0.0, atol=1e-12, scheduler=sched)
        assert meta.converged
        assert np.allclose(np.asarray(X), fp_minus, atol=1e-8)


@pytest.mark.slow
def test_newton_roessler_upo():
    """BASELINE config 5: unstable periodic orbit of the Roessler system via
    Newton-Krylov shooting, validated against the reference anchors:
    period-1 UPO with T ~ 5.8811 and Lyapunov exponents
    (0.149141556, 0.0) (reference: example/roessler/main.f90:87-88 seed,
    roessler_OTD.f90:32 anchors)."""
    from lightkrylov_tpu.models import floquet_exponents, flow

    sys = upo_system(n_steps=3000)
    X0 = {"pos": jnp.asarray(np.array([0.0, 6.1, 1.3])),  # reference seed
          "T": jnp.asarray(6.0)}
    opts = lk.NewtonOptions(maxiter=60)
    gopts = lk.GMRESOptions(kdim=4, maxiter=10)
    X, info, meta = lk.newton(sys, X0, rtol=0.0, atol=1e-11, options=opts,
                              linear_solver_options=gopts)
    assert meta.converged, f"residuals: {meta.residuals}"
    T = float(X["T"])
    assert abs(T - 5.88108845) < 1e-5
    closure = flow(X["pos"], X["T"], 3000) - X["pos"]
    assert float(jnp.linalg.norm(closure)) < 1e-8
    # Floquet/Lyapunov anchors (roessler_OTD.f90:32)
    mu, LE = floquet_exponents(X["pos"], X["T"], 4000)
    assert abs(LE[0] - 0.149141556) < 1e-6
    assert abs(LE[1]) < 1e-8


def test_otd_instantaneous_eigs_fixed_point():
    """OTD modes at the Roessler fixed point: instantaneous reduced-operator
    eigenvalue real parts = 0.097000856 (x2)
    (reference anchor: roessler_OTD.f90:31)."""
    from lightkrylov_tpu.models import otd_evolve, roessler_rhs

    fp_minus, _ = roessler_fixed_points()
    U0 = jnp.asarray(np.linalg.qr(
        np.random.default_rng(0).standard_normal((3, 2)))[0])
    x, U, Lr, lyap = otd_evolve(roessler_rhs, jnp.asarray(fp_minus), U0,
                                50.0, 20000)
    w = np.linalg.eigvals(np.asarray(Lr))
    assert np.allclose(np.sort(w.real), [0.097000856, 0.097000856], atol=1e-7)


def test_kexpm_mat_block(dtype_dp, rng):
    """Block Krylov expm vs dense on a 3-column block
    (reference: kexpm_mat, ExpmLib.fypp:234-363)."""
    dtype = dtype_dp
    A = (_rand(dtype, rng, (N, N)) / np.sqrt(N)).astype(dtype)
    B = _rand(dtype, rng, (3, N))  # stacked block of 3 columns
    C, info = lk.kexpm_mat(jnp.asarray(A), jnp.asarray(B), 0.4, tol=1e-10,
                           kdim=60)
    assert info > 0
    E = sla.expm(0.4 * A)
    for j in range(3):
        exact = E @ B[j]
        got = np.asarray(jax.tree_util.tree_leaves(C)[0])[j]
        assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 1e-8


def test_newton_target_tol_recheck():
    """Convergence declared at a relaxed scheduler tolerance must be
    re-validated at the *target* tolerance with an accurate residual
    evaluation (reference: NewtonKrylov.fypp:369-387).  The system's eval
    degrades its accuracy to the requested tol, so a relaxed-tol pass that
    skipped the recheck would accept a state whose true residual fails."""
    from lightkrylov_tpu.systems import System

    base = fixed_point_system()

    def sloppy_response(x, atol):
        # Forwards to the Roessler residual but perturbs it by ~0.3*atol —
        # detectable only through the target-tol re-evaluation.
        return base.eval(x, atol) + 0.3 * atol

    sloppy = System(sloppy_response, jacobian=lambda x: base.jacobian(x),
                    takes_atol=True)
    fp_minus, _ = roessler_fixed_points()
    X0 = jnp.zeros(3, jnp.float64)
    X, info, meta = lk.newton(sloppy, X0, rtol=0.0, atol=1e-10,
                              scheduler=lk.dynamic_tol)
    assert info > 0
    # the final recorded residual passed the target tolerance
    assert meta.residuals[-1] < 1e-10 + 0.31e-10
    assert np.allclose(np.asarray(X), fp_minus, atol=1e-8)


def test_auto_instrumentation_counters_and_timers():
    """gmres/eigs/cg record per-operator matvec counts and named timers
    WITHOUT user opt-in (reference: AbstractLinops.fypp:390-424 counting,
    Timer.fypp self-timing)."""
    from lightkrylov_tpu.models import Poisson2D, TridiagToeplitz
    from lightkrylov_tpu.utils import timer as tm

    tm.reset_counters()
    tm.set_timing(True)
    try:
        op = Poisson2D(16, dtype=jnp.float64)
        rng = np.random.default_rng(0)
        b = jnp.asarray(rng.standard_normal((16, 16)))
        x, info, _ = lk.cg(op, b, rtol=1e-8)
        assert tm.get_counter("Poisson2D.matvec") >= abs(info) + 1

        T = TridiagToeplitz(64, a=2.0, b=-1.0, c=-0.5, dtype=jnp.float64)
        bt = jnp.asarray(rng.standard_normal(64))
        x, info, _ = lk.gmres(T, bt, rtol=1e-8)
        assert tm.get_counter("TridiagToeplitz.matvec") > 0

        vals, vecs, res, info, _ = lk.eigs(T, nev=2, kdim=12,
                                           x0=jnp.ones(64, jnp.float64))
        assert tm.get_counter("TridiagToeplitz.matvec") > 12

        # named timers were populated by the solver brackets
        names = {t.name for t in tm.global_watch._timers.values() if t.count}
        assert {"cg", "gmres", "eigs"} <= names
        summary = tm.global_watch.summary()
        assert "IterativeSolvers" in summary
        assert "TridiagToeplitz.matvec" in tm.counters_summary()
    finally:
        tm.set_timing(False)
        tm.reset_counters()
