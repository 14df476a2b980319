"""True multi-process distributed test.

Everything else in the suite runs on a *virtual* 8-device mesh inside one
process; this test spawns TWO real OS processes, each with 2 virtual CPU
devices, joined by ``comm_setup`` (``jax.distributed.initialize`` + gloo
cross-process CPU collectives).  The child (tests/_mp_child.py) checks
rank/io-rank capture, sharded-matvec halo exchange across the process
boundary, the CGS2 fused all-reduce, and a full GMRES solve on the
2-process mesh (reference: the MPI surface in Logger.f90:245-276 and
Constants.f90:60-100, which the reference never tests in-repo either —
SURVEY.md §4).
"""

import os
import socket
import subprocess
import sys

import pytest

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_mp_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_children(port: int):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH",
                        "JAX_NUM_CPU_DEVICES")}
    env["PYTHONPATH"] = REPO  # only the repo on the children's path
    procs = [subprocess.Popen(
        [sys.executable, CHILD, str(pid), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


@pytest.mark.slow
def test_two_process_mesh():
    procs, outs = _run_children(_free_port())
    if any(p.returncode != 0 for p in procs) and \
            any("initialize" in o or "bind" in o for o in outs):
        # _free_port closes the socket before the coordinator rebinds it —
        # a rare reuse race; retry once on a fresh port.
        procs, outs = _run_children(_free_port())
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "ALL-OK" in out, f"process {pid} incomplete:\n{out}"
