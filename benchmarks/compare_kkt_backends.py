"""KKT-backend and scaling comparison bench.

Covers the roles of the reference's `BenchmarkSolvers.jl` (solver-vs-solver
size sweep, :20-98), `LinearSystemSolversFun.jl` (standalone strategy cost
models), and `LinearSystemSolversFunBenchmark.jl` (strategy bench with a
correctness check vs a dense solve, :100-107).

Usage:
    python benchmarks/compare_kkt_backends.py [--sizes 64 128 256] [--batch 64]

Emits one line per (backend, size): best solve time, solves/s, iterations,
plus a per-backend KKT-solve correctness check against jnp.linalg.solve.
Runs on whatever device JAX selects (the GPU where there is one, the CPU
with JAX_PLATFORMS=cpu). Records the whole table, with the device it ran
on, to benchmarks/results/kkt_backends.json (the reference's exploration
files exist to produce comparative measurements,
LinearSystemSolversFun.jl:191-234). Every (backend, size) cell is a fresh
compile; the persistent compilation cache makes re-runs fast.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, nargs="+", default=[64, 128, 256])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--samples", type=int, default=3)
    p.add_argument("--eps", type=float, default=1e-5)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.core.settings import KKTBackendKind
    from quadraticprogramsolver_tpu.models import kkt
    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    sync = jax.block_until_ready

    backends = [KKTBackendKind.CHOLESKY, KKTBackendKind.KKT_LDL,
                KKTBackendKind.CG, KKTBackendKind.KKT_MINRES]
    correctness_rows, size_rows, crossover_rows = [], [], []

    # Correctness check of each backend's KKT solve vs a dense solve
    # (LinearSystemSolversFunBenchmark.jl:100-107).
    data = qps.generate_random_qp(qps.ProblemClass.RANDOM_QP, 32, seed=0)
    qp1 = qps.make_qp(*data.dense(), dtype=np.float64)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(qp1.n))
    z = jnp.asarray(rng.standard_normal(qp1.m))
    y = jnp.asarray(rng.standard_normal(qp1.m))
    rho_val = 0.37
    # The dense reference must use the backend's EFFECTIVE sigma: solve()
    # applies the dtype-aware floor internally (Settings.sigma_for), so a
    # raw 1e-6 here would compare against a different KKT system in f32
    # (and the refinement would faithfully converge to the floored-sigma
    # solution, ~1e-3 away).
    sigma = qps.Settings().sigma_for(qp1.dtype)
    P, q, A = data.P.toarray(), data.q, data.A.toarray()
    K = np.block([[P + sigma * np.eye(qp1.n), A.T],
                  [A, -np.eye(qp1.m) / rho_val]])
    v = np.linalg.solve(K, np.concatenate([sigma * np.asarray(x) - q,
                                           np.asarray(z) - np.asarray(y) / rho_val]))
    xx_ref = v[: qp1.n]
    for kind in backends:
        st = qps.Settings(kkt_backend=kind, cg_eps=1e-12, cg_max_iterations=2000)
        b = kkt.get_backend(kind, qp1)
        rho = jnp.full((), rho_val, qp1.dtype)
        # Same precision regime as solve() (models/admm.py): the ambient
        # default may be TF32 on the GPU, which floors a raw backend call
        # at ~1e-3 — not how the backends ever run inside the solver.
        with jax.default_matmul_precision(st.matmul_precision):
            cache = b.init(qp1, rho, jnp.asarray(sigma, qp1.dtype), st)
            xx, _, _ = b.solve(cache, qp1, x, z, y, rho, st)
        scale = np.abs(xx_ref).max() + 1.0
        err = np.abs(np.asarray(xx) - xx_ref).max() / scale
        print(f"correctness {kind.value:>10}: rel|xx - dense|_inf = {err:.2e}")
        correctness_rows.append({"backend": kind.value, "rel_err": err})
        # Without jax_enable_x64 the device solve runs in f32; 1e-5
        # relative is the refined-f32 bar.
        assert err < 1e-5, kind

    print(f"\n{'backend':>10} {'n':>5} {'B':>5} {'best_ms':>9} "
          f"{'solves/s':>10} {'p50 iters':>9} {'solved':>7}")
    for n in args.sizes:
        fleet = qps.generate_batch(qps.ProblemClass.RANDOM_QP, args.batch, n,
                                   seed=1234, dtype=np.float32)
        for kind in backends:
            st = qps.Settings(max_iterations=4000, eps_abs=args.eps,
                              eps_rel=args.eps, rho=0.1, adaptive_rho=True,
                              kkt_backend=kind)
            try:
                sol = qps.solve_jit(fleet, st)
                sync(sol.x)
                times = []
                for _ in range(args.samples):
                    t0 = time.perf_counter()
                    sol = qps.solve_jit(fleet, st)
                    sync(sol.x)
                    times.append(time.perf_counter() - t0)
                best = min(times)
                status = np.asarray(sol.info.status)
                iters = np.asarray(sol.info.iterations)
                solved = int((status >= 2).sum())
                print(f"{kind.value:>10} {n:>5} {args.batch:>5} "
                      f"{best*1e3:>9.1f} {solved/best:>10.0f} "
                      f"{np.median(iters):>9.0f} {solved}/{args.batch}")
                size_rows.append({
                    "backend": kind.value, "n": n, "batch": args.batch,
                    "best_ms": best * 1e3, "solves_per_s": solved / best,
                    "p50_iters": float(np.median(iters)), "solved": solved})
            except Exception as e:  # pragma: no cover
                print(f"{kind.value:>10} {n:>5}: failed ({type(e).__name__}: {e})",
                      file=sys.stderr)
                size_rows.append({"backend": kind.value, "n": n,
                                  "batch": args.batch, "error": str(e)[:200]})

    # CG-vs-MINRES crossover on the ill-conditioned families (CG squares
    # the KKT condition number; MINRES does not). Runs both
    # iterative backends at a tight inner tolerance and reports solve time
    # and outer-iteration medians per family.
    print(f"\nill-conditioned crossover (B={args.batch}, n={args.sizes[-1]}):")
    print(f"{'family':>12} {'backend':>11} {'best_ms':>9} {'p50 iters':>9} "
          f"{'solved':>7}")
    # HUBER's paper-default ratio is m ~ 100n (num_elements=256 implies a
    # 77k-variable QP — a dense 64-lane batch of those is ~1.5 TB and got
    # this script OOM-killed twice); cap its constraints like the test
    # suite's SMALL_M does.
    capped = {qps.ProblemClass.HUBER: 60}
    for family in (qps.ProblemClass.PORTFOLIO, qps.ProblemClass.HUBER,
                   qps.ProblemClass.RANDOM_QP):
        fleet = qps.generate_batch(family, args.batch, args.sizes[-1],
                                   capped.get(family, 0),
                                   seed=1234, dtype=np.float32)
        for kind in (KKTBackendKind.CG, KKTBackendKind.KKT_MINRES):
            st = qps.Settings(max_iterations=4000, eps_abs=args.eps,
                              eps_rel=args.eps, rho=0.1, adaptive_rho=True,
                              cg_max_iterations=500, kkt_backend=kind)
            try:
                sol = qps.solve_jit(fleet, st)
                sync(sol.x)
                times = []
                for _ in range(args.samples):
                    t0 = time.perf_counter()
                    sol = qps.solve_jit(fleet, st)
                    sync(sol.x)
                    times.append(time.perf_counter() - t0)
                status = np.asarray(sol.info.status)
                iters = np.asarray(sol.info.iterations)
                solved = int((status >= 2).sum())
                print(f"{family.name:>12} {kind.value:>11} "
                      f"{min(times)*1e3:>9.1f} {np.median(iters):>9.0f} "
                      f"{solved}/{args.batch}")
                crossover_rows.append({
                    "family": family.name, "backend": kind.value,
                    "n": args.sizes[-1], "batch": args.batch,
                    "best_ms": min(times) * 1e3,
                    "p50_iters": float(np.median(iters)), "solved": solved})
            except Exception as e:  # pragma: no cover
                print(f"{family.name:>12} {kind.value:>11}: failed "
                      f"({type(e).__name__}: {e})", file=sys.stderr)
                crossover_rows.append({
                    "family": family.name, "backend": kind.value,
                    "error": str(e)[:200]})

    dev = jax.devices()[0]
    artifact = {
        "benchmark": "kkt_backends",
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "eps": args.eps,
        "correctness": correctness_rows,
        "size_sweep": size_rows,
        "crossover": crossover_rows,
    }
    path = os.path.join(os.path.dirname(__file__), "results",
                        "kkt_backends.json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    print("\nwrote " + path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
