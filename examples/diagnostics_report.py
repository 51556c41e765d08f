"""Diagnostic-report example: residual trace + constraint map + scatter.

    python examples/diagnostics_report.py [--out qp_report]

Covers the reference's manual-verification plot role
(/root/reference/SolveQuadraticProgramUnitTest.jl:78-79, ProxQP002.jl:190-212):
solve one portfolio QP with per-check tracing on, print the text report, and
render the PNG when matplotlib is available.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))



def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="qp_report",
                   help="path prefix of the .txt and .png reports")
    p.add_argument("--n", type=int, default=120)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    # A single f64 QP: host work, run on the CPU whatever else is attached.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.utils.diagnostics import (
        save_report_png, solve_report)

    data = qps.generate_random_qp(qps.ProblemClass.PORTFOLIO, args.n, seed=1)
    qp_arrays = data.dense()
    settings = qps.Settings(eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
                            adaptive_rho=True, record_history=True,
                            check_interval=25)
    sol = qps.solve_jit(qps.make_qp(*qp_arrays, dtype=np.float64), settings)

    report = solve_report(qp_arrays, sol,
                          check_interval=settings.check_interval)
    print(report)
    txt = args.out + ".txt"
    with open(txt, "w") as f:
        f.write(report)
    print(f"text report -> {txt}")
    png = save_report_png(qp_arrays, sol, args.out + ".png",
                          check_interval=settings.check_interval)
    print(f"png report  -> {png}" if png else "matplotlib unavailable; "
          "text report only")
    return 0


if __name__ == "__main__":
    sys.exit(main())
