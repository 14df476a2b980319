"""Utility-layer tests: timers, logger/check_info, counters, sqrtm,
givens rotations, checkpoint/resume
(reference models: Timer_Utils tests, Logger check_info decoding
Logger.f90:316-748, sqrtm tests TestExpmlib.fypp:238-364)."""

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lightkrylov_tpu as lk
from lightkrylov_tpu import vectors
from lightkrylov_tpu.krylov import arnoldi, initialize_arnoldi
from lightkrylov_tpu.utils import checkpoint, linalg
from lightkrylov_tpu.utils.logger import LightKrylovError, check_info
from lightkrylov_tpu.utils.timer import (
    Timer,
    Watch,
    get_counter,
    matvec_counter,
    reset_counters,
    set_timing,
    timed,
)


# -- timers ------------------------------------------------------------------

def test_timer_basic():
    t = Timer("t")
    t.start(); time.sleep(0.01); t.stop()
    t.start(); time.sleep(0.01); t.stop()
    assert t.count == 2
    assert t.etime >= 0.02
    assert t.tmin <= t.tmax
    t.reset(soft=True)
    assert t.count == 0 and len(t.history) == 1
    t.reset(soft=False)
    assert len(t.history) == 0


def test_watch_groups_and_summary():
    w = Watch("test_watch")
    w.add_timer("a", group="g1")
    w.add_timer("b", group="g2")
    w.timer("a").start(); w.timer("a").stop()
    s = w.summary()
    assert "g1" in s and "a" in s
    w.remove_timer("a")
    assert "a" not in w._timers


def test_timed_context_gated():
    from lightkrylov_tpu.utils.timer import global_watch
    set_timing(False)
    with timed("not_recorded"):
        pass
    assert "not_recorded" not in global_watch._timers
    set_timing(True)
    with timed("recorded"):
        pass
    assert global_watch._timers["recorded"].count == 1
    set_timing(False)


def test_matvec_counter_eager_and_jit():
    """(reference: apply_matvec counters, AbstractLinops.fypp:391-424)."""
    reset_counters()
    op = matvec_counter(lk.DenseOperator(jnp.eye(4)), "A")
    x = jnp.ones(4)
    op.matvec(x)
    op.matvec(x)
    op.rmatvec(x)
    assert get_counter("A.matvec") == 2
    assert get_counter("A.rmatvec") == 1
    # inside jit: io_callback counts executions (CPU supports callbacks)
    jax.jit(op.matvec)(x).block_until_ready()
    assert get_counter("A.matvec") == 3


def test_matvec_counter_trace_fallback():
    """Pin the no-host-callback fallback: with
    ``set_callback_counting(False)`` (for runtimes without io_callback)
    jitted counts record *traces* (one per compilation), not executions;
    eager counts are unaffected."""
    from lightkrylov_tpu.utils.timer import set_callback_counting

    reset_counters()
    set_callback_counting(False)
    try:
        op = matvec_counter(lk.DenseOperator(jnp.eye(4)), "B")
        x = jnp.ones(4)
        op.matvec(x)                       # eager: counted
        assert get_counter("B.matvec") == 1
        f = jax.jit(op.matvec)
        f(x).block_until_ready()           # compile: one trace-time count
        f(x).block_until_ready()           # cached executions: NOT counted
        f(x).block_until_ready()
        assert get_counter("B.matvec") == 2
    finally:
        set_callback_counting(True)
        reset_counters()


# -- logger ------------------------------------------------------------------

def test_check_info_benign_and_fatal():
    check_info(0, "gmres")           # no-op
    check_info(5, "arnoldi")         # benign breakdown, logs only
    check_info(-2, "kexpm")          # benign for kexpm
    check_info(-7, "gmres")          # solver non-convergence: warning only
    check_info(-3, "cg")             # (reference: Logger.f90:653-667)
    with pytest.raises(LightKrylovError):
        check_info(-1, "qr")         # process failure stays fatal
    with pytest.raises(LightKrylovError):
        check_info(-4, "arnoldi")


def test_logger_setup_levels(caplog):
    lk.logger_setup(log_level=logging.WARNING)
    with caplog.at_level(logging.INFO, logger="lightkrylov_tpu"):
        lk.logger.log_information("hidden")
        lk.logger.log_warning("shown")
    lk.logger_setup()  # restore defaults


def test_greetings():
    assert "lightkrylov_tpu" in lk.greetings()


# -- dense utils -------------------------------------------------------------

def test_sqrtm_posdef(dtype_dp):
    """(reference: sqrtm tests, TestExpmlib.fypp:238-364)."""
    rng = np.random.default_rng(0)
    M = rng.standard_normal((16, 16))
    if np.issubdtype(np.dtype(dtype_dp), np.complexfloating):
        M = M + 1j * rng.standard_normal((16, 16))
    A = (M @ M.conj().T + 16 * np.eye(16)).astype(dtype_dp)
    S, info = linalg.sqrtm(jnp.asarray(A))
    S = np.asarray(S)
    assert np.allclose(S @ S, A, atol=1e-10)
    assert info == 0  # positive definite (submodule_utility_functions.fypp:151-158)


def test_sqrtm_semidefinite():
    rng = np.random.default_rng(1)
    M = rng.standard_normal((16, 4))
    A = M @ M.T  # rank 4 PSD
    S, info = linalg.sqrtm(jnp.asarray(A))
    S = np.asarray(S)
    assert np.allclose(S @ S, A, atol=1e-10)
    assert info == 1  # semi-definite flagged (submodule_utility_functions.fypp:156)


def test_sqrtm_non_hermitian_fatal():
    """Symmetry validation is fatal beyond rtol (reference:
    submodule_utility_functions.fypp:133-144)."""
    import pytest

    A = np.eye(8) + np.triu(np.ones((8, 8)), 1)  # grossly non-symmetric
    with pytest.raises(Exception):
        linalg.sqrtm(jnp.asarray(A))


def test_givens_rotation_annihilates(dtype):
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(2)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a, b = a + 1j * 0.3, b - 1j * 0.7
    a = jnp.asarray(np.array(a, dtype=dtype))
    b = jnp.asarray(np.array(b, dtype=dtype))
    c, s = linalg.givens_rotation(a, b)
    lo = -s * a + c * b
    assert abs(complex(lo)) < 1e-6
    # rotation preserves the norm
    r = c * a + jnp.conj(s) * b
    assert np.isclose(abs(complex(r)), np.sqrt(abs(complex(a))**2 + abs(complex(b))**2), rtol=1e-5)


def test_ordschur_moves_selected():
    """(reference: ordschur via TRSEN, Utils.fypp)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((8, 8))
    T, Z = linalg.schur(jnp.asarray(A))
    w = np.linalg.eigvals(T)
    # select the eigenvalue with largest real part
    mask = np.zeros(8, bool)
    mask[np.argmax(w.real)] = True
    # pair-consistent selection handled by schur_select; use it directly
    Ts, Zs, n = linalg.schur_select(jnp.asarray(A), lambda ev: ev.real >= np.max(ev.real) - 1e-12)
    kept = np.linalg.eigvals(Ts[:n, :n])
    assert np.max(kept.real) >= np.max(w.real) - 1e-10
    # similarity preserved
    assert np.allclose(Zs @ Ts @ Zs.T, A, atol=1e-10)


# -- checkpoint --------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = {"X": jnp.arange(12.0).reshape(3, 4), "k": jnp.asarray(7),
             "nested": {"H": jnp.ones((2, 2))}}
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(state, path)
    restored = checkpoint.load_checkpoint(jax.tree.map(jnp.zeros_like, state), path)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        assert np.allclose(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_arnoldi(dtype_dp):
    """Save a half-built factorization, restore, continue: identical result
    (the resume capability the reference lacks — SURVEY.md §5)."""
    import tempfile, os
    rng = np.random.default_rng(4)
    A = rng.standard_normal((64, 64)).astype(dtype_dp)
    if np.issubdtype(np.dtype(dtype_dp), np.complexfloating):
        A = A + 1j * rng.standard_normal((64, 64)).astype(np.float64)
        A = A.astype(dtype_dp)
    op = lk.DenseOperator(jnp.asarray(A))
    x0 = vectors.rand_like(jax.random.PRNGKey(0), jnp.zeros(64, dtype_dp))
    kdim = 10
    # full run
    Xf, Hf = initialize_arnoldi(x0, kdim)
    Xf, Hf, _ = arnoldi(op, Xf, Hf)
    # half run + checkpoint + resume
    X, H = initialize_arnoldi(x0, kdim)
    X, H, _ = arnoldi(op, X, H, kend=5)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "state.npz")
        checkpoint.save_checkpoint({"X": X, "H": H, "k": jnp.asarray(5)}, p)
        st = checkpoint.load_checkpoint(
            {"X": jax.tree.map(jnp.zeros_like, X), "H": jnp.zeros_like(H),
             "k": jnp.asarray(0)}, p)
    Xr, Hr, _ = arnoldi(op, st["X"], st["H"], kstart=int(st["k"]) + 1)
    assert np.allclose(np.asarray(Hr), np.asarray(Hf), atol=1e-12)


def test_per_instance_operator_counters():
    """Two operators of the SAME class keep separate counters (the
    reference counts per-instance, AbstractLinops.fypp:34-37).
    The first instance counted keeps the bare class name; a `label`
    attribute overrides the generated name."""
    from lightkrylov_tpu.utils.timer import count_applications, operator_label

    reset_counters()
    A = lk.DenseOperator(jnp.eye(4))
    M = lk.DenseOperator(2.0 * jnp.eye(4))
    count_applications(A, 3)
    count_applications(M, 5)
    assert get_counter("DenseOperator.matvec") == 3
    assert get_counter("DenseOperator#1.matvec") == 5
    # stable across repeated calls on the same instances
    count_applications(A, 1)
    assert get_counter("DenseOperator.matvec") == 4
    # explicit label wins
    P = lk.DenseOperator(jnp.eye(4))
    P.label = "precond"
    count_applications(P, 2)
    assert get_counter("precond.matvec") == 2
    assert operator_label(P) == "precond"
    reset_counters()
    # after reset the naming epoch restarts: a fresh first instance gets
    # the bare class name again
    B = lk.DenseOperator(jnp.eye(4))
    count_applications(B, 1)
    assert get_counter("DenseOperator.matvec") == 1
    reset_counters()


def test_standalone_krylov_routines_timed_and_counted():
    """Driving arnoldi/lanczos directly (the reference's incremental-use
    pattern) records timing + execution-accurate matvec counts when
    instrumentation is on (reference: arnoldi.fypp:18,75)."""
    from lightkrylov_tpu.krylov import arnoldi, initialize_arnoldi
    from lightkrylov_tpu.utils import timer as tm

    tm.reset_counters()
    tm.set_timing(True)
    try:
        A = lk.DenseOperator(jnp.asarray(
            np.random.default_rng(0).standard_normal((32, 32))))
        x0 = jnp.ones(32, jnp.float64)
        X, H = initialize_arnoldi(x0, 8)
        X, H, info = arnoldi(A, X, H)
        assert tm.get_counter("DenseOperator.matvec") == 8
        names = {t.name for t in tm.global_watch._timers.values() if t.count}
        assert "krylov.arnoldi" in names
    finally:
        tm.set_timing(False)
        tm.reset_counters()


def test_gram_schmidt_zero_column_info():
    """Block CGS2 flags a column that vanishes inside the projection
    (reference: gram_schmidt.fypp:127,171-173)."""
    from lightkrylov_tpu.krylov.gram_schmidt import double_gram_schmidt_step
    from lightkrylov_tpu import vectors as vec

    rng = np.random.default_rng(0)
    # orthonormal basis spanning the first 3 coordinates
    X = jnp.zeros((3, 8), jnp.float64)
    X = X.at[0, 0].set(1.0).at[1, 1].set(1.0).at[2, 2].set(1.0)
    # block: col 0 generic, col 1 entirely inside span(X) -> vanishes
    blk = jnp.stack([jnp.asarray(rng.standard_normal(8)),
                     0.7 * X[0] + 0.2 * X[2]])
    y, proj, info = double_gram_schmidt_step(blk, X, return_info=True)
    assert int(info) == 2  # 1-based index of the vanished column
    # generic block: no flag
    blk2 = jnp.asarray(rng.standard_normal((2, 8)))
    _, _, info2 = double_gram_schmidt_step(blk2, X, return_info=True)
    assert int(info2) == 0
    # single-vector path
    v = 0.3 * X[1]
    _, _, info3 = double_gram_schmidt_step(v, X, return_info=True)
    assert int(info3) == 1


def test_comm_close_noop_single_process():
    """comm_close is safe (no-op) without a distributed runtime
    (reference: Logger.f90:277-288 guarded MPI finalize)."""
    from lightkrylov_tpu.parallel import comm_close

    comm_close()  # must not raise


def test_compile_cache_uses_env_dir_and_sets_nothing(monkeypatch, tmp_path):
    from lightkrylov_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout_dir(monkeypatch):
    import os

    from lightkrylov_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
