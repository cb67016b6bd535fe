"""Spread of ``BENCH_sched.json``'s capacity-capped HEFT row on the CPU: the
reference's (``benchmarks/sched_policies.py``) and the port's
(``repro_torch.sched_policies``) evictions, refetches, ``bytes_to`` and
``bytes_from``, run side by side under load.  Each round starts ``PER``
children of each package at once, single-threaded; the counts (not times)
are printed as JSON after each round.  Not a test: a probe of the row's
timing dependence (ROADMAP.md §3, PERF.md §7).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/capped_row_spread.py 5 4
"""
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ROW = "print(json.dumps([r[k] for k in ('evictions', 'refetches', 'bytes_to', 'bytes_from')]))"
CODE = {
    "reference": "import sys, json; sys.path.insert(0, '.'); "
                 "import benchmarks.sched_policies as s; r = s.run_sparselu()[-1]; " + ROW,
    "port": "import json, torch; torch.set_num_threads(1); "
            "from repro_torch import sched_policies as s; "
            "r = s.run_sparselu(device='cpu')[-1]; " + ROW,
}


def main(rounds: int, per: int) -> dict:
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    out = {k: [] for k in CODE}
    for _ in range(rounds):
        procs = [(k, subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
                 for _ in range(per) for k, code in CODE.items()]
        for k, p in procs:
            stdout, stderr = p.communicate()
            if p.returncode:
                raise SystemExit(f"{k} exited {p.returncode}: {stderr[-800:]}")
            out[k].append(json.loads(stdout.strip().splitlines()[-1]))
        print(json.dumps(out), flush=True)
    for k, rows in out.items():
        ev = [r[0] for r in rows]
        print(f"{k}: {len(rows)} runs, evictions {min(ev)}-{max(ev)} "
              f"(mean {sum(ev) / len(ev)}), evictions - refetches "
              f"{sorted({r[0] - r[1] for r in rows})}")
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]))
