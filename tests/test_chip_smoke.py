"""chip_smoke.py rehearsed on the CPU: every phase at a tiny size (the
script's own checks must pass), the sharded path on the virtual mesh, and
the refusal to run without a GPU."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _clear_caches_between_phases():
    """Each phase compiles many programs; drop them between tests to stay
    clear of the XLA-CPU compile crash described in conftest.py."""
    yield
    import jax

    jax.clear_caches()


TINY = {
    "pcg_poisson": dict(n=16),
    "gmres_poisson_large": dict(n=64, n_small=32, cycles=2, kdim=8),
    "eighs_poisson_large": dict(n=64, n_conv=16, nev=2, kdim=8, kdim_conv=16),
    "gl_eigs_complex": dict(nx=64, nev=2, kdim=8, tau=0.1),
    "gl_eigs_projected": dict(nx=32, nev=2, kdim=16, tau=0.05),
    "roessler": dict(n_steps=1000, otd_steps=20000),
    "svds_kexpm": dict(m=16, n_dense=24),
    "bell_spmv": dict(nbr=64, K=3, bn=32),
    "kernels": dict(n=64, nbr=64),
}


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_passes_at_tiny_size(name, capsys):
    ph = chip_smoke.Phase(name)
    chip_smoke.PHASES[name](ph, **TINY[name])
    out = capsys.readouterr().out
    assert not ph.failures, out
    assert "FAIL" not in out


def test_four_sharded_on_virtual_devices(capsys):
    import jax

    if jax.device_count() < 4:
        pytest.skip("needs the virtual multi-device CPU mesh")
    ph = chip_smoke.Phase("four_sharded")
    chip_smoke.four_sharded(ph, n=64, nbr=64, gl_nx=64, n_dev=4)
    out = capsys.readouterr().out
    assert not ph.failures, out


def test_failed_check_marks_phase_failed(capsys):
    ph = chip_smoke.Phase("demo")
    assert ph.check("within", 1e-9, 1e-8, "float64", "demo")
    assert not ph.check("beyond", 1e-7, 1e-8, "float64", "demo")
    assert not ph.check("nan", float("nan"), 1.0, "float64", "demo")
    assert ph.failures == ["beyond", "nan"]
    failed = chip_smoke.run_phases(
        {"boom": lambda ph: (_ for _ in ()).throw(RuntimeError("x"))})
    assert failed == ["boom"]


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 2
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "needs a GPU" in captured.err


# moderate sizes: large enough to exercise the GPU path, small enough for a
# test run (the full sizes are chip_smoke.py's defaults)
MEDIUM = {
    "pcg_poisson": dict(n=128),
    "gmres_poisson_large": dict(n=2048, n_small=256, cycles=2),
    "eighs_poisson_large": dict(n=2048, n_conv=64, kdim_conv=32),
    "gl_eigs_complex": dict(nx=128, nev=4, tau=0.1),
    "bell_spmv": dict(nbr=4096),
    "kernels": dict(n=2048, nbr=4096),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(MEDIUM))
def test_phase_passes_on_gpu(gpu, name, capsys):
    ph = chip_smoke.Phase(name)
    chip_smoke.PHASES[name](ph, **MEDIUM[name])
    out = capsys.readouterr().out
    assert not ph.failures, out
