"""Full 9-class benchmark sweep (the RunBenchmarks.jl grid) on the default
device.

All classes are zero-padded to one shared shape so the whole sweep reuses a
single compiled executable. Emits CSV/JSONL via the harness and prints the
table.

    python benchmarks/sweep_classes.py [--n 64] [--batch 64] [--out results]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--samples", type=int, default=2)
    p.add_argument("--out", type=str, default=None,
                   help="directory for CSV/JSONL results")
    args = p.parse_args(argv)

    import jax

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.bench.harness import (
        BenchCase,
        emit_results,
        run_case,
    )
    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    n = args.n
    cap_m = n  # cap the m=100n families
    # Worst-case dims across families at (n, cap_m):
    #   huber: vars n+3m, cons 3m; lasso: vars 2n+m, cons m+2n.
    n_pad = n + 3 * cap_m
    m_pad = max(3 * cap_m, cap_m + 2 * n)
    capped = {qps.ProblemClass.LASSO, qps.ProblemClass.HUBER,
              qps.ProblemClass.SVM, qps.ProblemClass.INEQUALITY_QP}
    # Robust f32 settings for the ill-conditioned families: 2 refinement
    # passes + Ruiz scaling lift huber from 57/64 to 63/64 solved at 1e-4.
    settings = qps.Settings(
        max_iterations=4000, eps_abs=1e-4, eps_rel=1e-4, rho=0.1,
        adaptive_rho=True, kkt_refinement_steps=2, scaling_iters=10)

    print(f"pad shape: ({n_pad}, {m_pad}); device: {jax.devices()[0]}")
    results = []
    for cls in qps.ALL_CLASSES:
        case = BenchCase(cls, n, cap_m if cls in capped else 0, args.batch,
                         pad_to=(n_pad, m_pad))
        r = run_case(case, settings, samples=args.samples)
        results.append(r)
        print(f"{cls.value:>16}: {r.best_time_sec*1e3:8.1f} ms  "
              f"{r.solves_per_sec:9.0f} solves/s  "
              f"p50 iters {r.median_iterations:5.0f}  "
              f"solved {r.solved}/{r.total}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        emit_results(results, os.path.join(args.out, "class_sweep.csv"),
                     os.path.join(args.out, "class_sweep.jsonl"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
