"""TRUE 2-process weak-scaling measurement over gloo collectives
(the only real-collective scaling measurement a single CPU host
permits).

Fixed work per process (rows_per_proc x nx Poisson rows), 1 vs 2 OS
processes joined by ``jax.distributed`` + gloo.  Every process is pinned
to its OWN physical core (taskset) — including the 1-process baseline —
so each process has identical compute resources and the efficiency ratio
isolates communication + synchronization overhead, not core sharing (the
round-2 virtual-mesh numbers were CPU-sharing artifacts and are labeled
as such in WEAK_SCALING.md).

Writes one JSON line (probe = "weak_scaling_2proc") to
benchmarks/results_mp.json and prints the efficiency table.

Run: python benchmarks/weak_scaling_mp.py  [--rows 768] [--nx 1024]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(HERE, "_ws_child.py")
REPO = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_job(nproc: int, rows: int, nx: int, solver: str, timeout=1800):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH",
                        "JAX_NUM_CPU_DEVICES")}
    env["PYTHONPATH"] = REPO
    port = free_port()
    procs = []
    for pid in range(nproc):
        cmd = ["taskset", "-c", str(pid % os.cpu_count()), sys.executable,
               CHILD, str(pid), str(nproc), str(port), str(rows), str(nx),
               solver]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, env=env,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"nproc={nproc} process {pid} failed:\n{out}")
    for out in outs:
        for line in out.splitlines():
            if line.startswith("WS-RESULT "):
                return json.loads(line[len("WS-RESULT "):])
    raise RuntimeError(f"no WS-RESULT line:\n{outs[0]}")


def run_baseline(nconc: int, rows: int, nx: int, solver: str, timeout=2400):
    """``nconc`` concurrent *independent* 1-process jobs (no collectives),
    pinned round-robin to the physical cores.

    This is the no-communication control at the SAME core oversubscription
    as an ``nconc``-process communicating job: on a machine with fewer
    cores than processes, comparing against a single solo run would fold
    CPU sharing into the "communication" cost (the round-2 virtual-mesh
    mistake).  Weak-scaling efficiency = max-over-children(median time of
    the independent jobs) / median time of the communicating job.
    """
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH",
                        "JAX_NUM_CPU_DEVICES")}
    env["PYTHONPATH"] = REPO
    procs = []
    for i in range(nconc):
        port = free_port()
        cmd = ["taskset", "-c", str(i % os.cpu_count()), sys.executable,
               CHILD, "0", "1", str(port), str(rows), str(nx), solver]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, env=env,
                                      text=True))
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"baseline child {i} failed:\n{out}")
    rs = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("WS-RESULT "):
                rs.append(json.loads(line[len("WS-RESULT "):]))
    assert len(rs) == nconc
    return rs


def _stats(times):
    """(median, iqr) of a repeat list."""
    t = sorted(times)
    n = len(t)
    med = t[n // 2]
    q1 = t[max(0, n // 4)]
    q3 = t[min(n - 1, (3 * n) // 4)]
    return med, q3 - q1


def run_reconcile(args):
    """Run BOTH baselines — direct (one solo job,
    idle machine) and concurrency-matched (N independent jobs
    simultaneously) — against the same N-process gloo job at one common
    size, and report median +/- IQR for every side with efficiencies
    capped at 1.0 (an 'efficiency' above 1 just means the baseline noise
    or its replicated work exceeds the communication cost being measured;
    the raw times are the auditable quantity).

    The two methodologies bracket the truth on this 2-core host: the
    direct ratio folds core oversubscription of the N-process job into
    'communication' (pessimistic), the matched ratio gives both sides the
    same core contention but lets the communicating job amortize
    replicated work (optimistic).  The real communication cost lies
    between; on separate devices the gap closes because processes do not
    share a memory controller."""
    results = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"),
               "probe": "weak_scaling_reconcile",
               "cores": os.cpu_count(),
               "rows_per_proc": args.rows, "nx": args.nx, "jobs": []}
    for solver in args.solvers.split(","):
        for nproc in [int(s) for s in args.nprocs.split(",")]:
            solo = run_baseline(1, args.rows, args.nx, solver)[0]
            matched = run_baseline(nproc, args.rows, args.nx, solver)
            comm = run_job(nproc, args.rows, args.nx, solver)
            t_solo, iqr_solo = _stats(solo["times"])
            t_match = max(r["median_s"] for r in matched)
            iqr_match = max(_stats(r["times"])[1] for r in matched)
            t_comm, iqr_comm = _stats(comm["times"])
            eff_direct = t_solo / t_comm
            eff_matched = t_match / t_comm
            dof = comm["dof"]
            print(f"{solver} nproc={nproc} ({dof / 1e6:.1f}M DoF): "
                  f"solo {t_solo:.2f}±{iqr_solo:.2f}s | matched "
                  f"{t_match:.2f}±{iqr_match:.2f}s | comm "
                  f"{t_comm:.2f}±{iqr_comm:.2f}s | eff direct "
                  f"{min(eff_direct, 1.0):.1%} (raw {eff_direct:.3f}) "
                  f"matched {min(eff_matched, 1.0):.1%} "
                  f"(raw {eff_matched:.3f})", flush=True)
            results["jobs"].append(
                {"solver": solver, "nproc": nproc, "dof": dof,
                 "t_solo_s": t_solo, "iqr_solo_s": round(iqr_solo, 4),
                 "t_matched_s": t_match, "iqr_matched_s": round(iqr_match, 4),
                 "t_comm_s": t_comm, "iqr_comm_s": round(iqr_comm, 4),
                 "eff_direct_capped": round(min(eff_direct, 1.0), 4),
                 "eff_direct_raw": round(eff_direct, 4),
                 "eff_matched_capped": round(min(eff_matched, 1.0), 4),
                 "eff_matched_raw": round(eff_matched, 4),
                 "solo_times": solo["times"],
                 "matched": matched, "comm": comm})
    out_path = os.path.join(HERE, "results_mp.json")
    with open(out_path, "a") as f:
        f.write(json.dumps(results) + "\n")
    print("appended to", out_path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=768)
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--nprocs", default="2")
    ap.add_argument("--solvers", default="gmres,eighs")
    ap.add_argument("--reconcile", action="store_true",
                    help="run BOTH direct and concurrency-matched "
                         "baselines at one size, report median±IQR, cap "
                         "efficiencies at 1.0")
    args = ap.parse_args()
    if args.reconcile:
        run_reconcile(args)
        return

    results = {"ts": time.strftime("%Y-%m-%d %H:%M:%S"),
               "probe": "weak_scaling_mp",
               "methodology": "concurrency-matched: N independent 1-proc "
                              "jobs vs N-proc gloo job, median-of-repeats",
               "cores": os.cpu_count(),
               "rows_per_proc": args.rows, "nx": args.nx, "jobs": []}
    for solver in args.solvers.split(","):
        for nproc in [int(s) for s in args.nprocs.split(",")]:
            base = run_baseline(nproc, args.rows, args.nx, solver)
            comm = run_job(nproc, args.rows, args.nx, solver)
            t_base = max(r["median_s"] for r in base)
            t_comm = comm["median_s"]
            eff = t_base / t_comm
            dof = comm["dof"]
            spread_c = (max(comm["times"]) - min(comm["times"])) / t_comm
            print(f"{solver} nproc={nproc}: indep {t_base:.3f}s | "
                  f"comm {t_comm:.3f}s ({dof/1e6:.1f}M DoF total) "
                  f"weak-eff = {eff:.1%}  spread = {spread_c:.0%}",
                  flush=True)
            results["jobs"].append(
                {"solver": solver, "nproc": nproc, "dof": dof,
                 "t_indep_s": t_base, "t_comm_s": t_comm,
                 "efficiency": round(eff, 4),
                 "comm_spread": round(spread_c, 3),
                 "baseline": base, "comm": comm})

    out_path = os.path.join(HERE, "results_mp.json")
    with open(out_path, "a") as f:
        f.write(json.dumps(results) + "\n")
    print("appended to", out_path)


if __name__ == "__main__":
    main()
