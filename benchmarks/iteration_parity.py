"""Iteration-count parity vs the reference-style OSQP oracle.

BASELINE.md's measurement points include "vs OSQP iteration counts": both
solvers run the same math (OSQP ADMM, rho=0.1, adaptive, eps 1e-7,
check_interval=25), so per-problem iteration counts should land within a
check interval of each other — this sweep records them side by side.
Differences beyond cadence come from f32-vs-f64 thresholds (run here in f64
to isolate the algorithm) and the oracle's scalar (unbatched) early exit.

    python benchmarks/iteration_parity.py      # CPU, writes CSV to results/

Optionally pass --anderson to add an AA column. NOTE: accelerated counts are USUALLY at or below plain, but the per-check
residual-margin safeguard does not bound iterations-to-exit — lasso/n=50/
seed 0 measures 150 plain -> 200 with AA (pinned as a regression test,
tests/test_anderson.py::test_lasso_seed0_aa_can_take_more_iterations).

Every SOLVED_ADMM (status 2, the fixed-point exit m:281-284) lane is
audited against the f64 oracle solution and the direct KKT conditions —
the fixed-point exit is exactly where a silently-stalled lane would hide,
so the CSV records `dev_vs_oracle` / `kkt_max_res` / `exit_audit` for it.
"""

import csv
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    # An algorithm check, not a speed one: f64 on the CPU.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.problems.generator import ALL_CLASSES
    from quadraticprogramsolver_tpu.utils.oracle import (
        kkt_optimality, solve_qp_reference)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from test_admm import FEASIBLE_SEEDS, SMALL_M  # probed feasible seeds

    st = qps.Settings(max_iterations=20000, eps_abs=1e-7, eps_rel=1e-7,
                      rho=0.1, adaptive_rho=True, check_interval=25)
    aa = "--anderson" in sys.argv
    rows = []
    for cls in ALL_CLASSES:
        for seed in FEASIBLE_SEEDS[cls][:3]:
            data = qps.generate_random_qp(
                cls, 10, num_constraints=SMALL_M.get(cls, 0), seed=seed)
            ref = solve_qp_reference(data.P, data.q, data.A, data.l, data.u,
                                     eps_abs=1e-7, eps_rel=1e-7, rho=0.1,
                                     max_iterations=20000)
            qp = qps.make_qp(*data.dense(), dtype=np.float64)
            sol = qps.solve_jit(qp, st)
            row = {"class": cls.value, "n": data.n, "seed": seed,
                   "iters_solver": int(sol.info.iterations),
                   "iters_oracle": int(ref.iterations),
                   "status_solver": int(sol.info.status),
                   "status_oracle": int(ref.status)}
            # Audit every SOLVED_ADMM (fixed-point, status 2) exit: the exit
            # tests iterate movement, not residuals, so a stalled lane could
            # hide behind it. Record solution deviation vs the oracle and the
            # direct KKT residuals; pass = dev <= 1e-5 (the RunTests.jl bar
            # at this eps) AND KKT residuals <= 1e-4 (the headline bar).
            if int(sol.info.status) == 2 and ref.status == 3:
                x = np.asarray(sol.x)
                dev = float(np.abs(x - ref.x).max())
                rep = kkt_optimality(data.P, data.q, data.A, data.l, data.u,
                                     x, y=np.asarray(sol.y))
                kkt_max = float(max(rep.res_prim, rep.res_dual, rep.res_comp))
                row["dev_vs_oracle"] = f"{dev:.2e}"
                row["kkt_max_res"] = f"{kkt_max:.2e}"
                row["exit_audit"] = ("pass" if dev <= 1e-5 and kkt_max <= 1e-4
                                     else "FAIL")
            else:
                row["dev_vs_oracle"] = row["kkt_max_res"] = ""
                row["exit_audit"] = ""
            if aa:
                sol_aa = qps.solve_jit(
                    qp, dataclasses.replace(st, anderson_memory=8))
                row["iters_aa"] = int(sol_aa.info.iterations)
            rows.append(row)
            print(row, flush=True)

    out = os.path.join(os.path.dirname(__file__), "results",
                       "iteration_parity.csv")
    with open(out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    solver_total = sum(r["iters_solver"] for r in rows)
    orc_total = sum(r["iters_oracle"] for r in rows)
    audited = [r for r in rows if r["exit_audit"]]
    fails = [r for r in audited if r["exit_audit"] == "FAIL"]
    print(f"total iterations: solver={solver_total} oracle={orc_total} "
          f"ratio={solver_total/orc_total:.2f} -> {out}")
    print(f"status-2 (SOLVED_ADMM) exit audits: {len(audited)} audited, "
          f"{len(fails)} FAIL"
          + (f" — {[(r['class'], r['seed']) for r in fails]}" if fails else ""))


if __name__ == "__main__":
    main()
