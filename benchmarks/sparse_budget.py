"""Config-4 (n=1e5 sparse) per-iteration budget.

    python benchmarks/sparse_budget.py [--n 100000] [--out PATH]

Decomposes one sparse solve's time on the default device and sweeps the
inner-forcing knobs:

  1. raw matvec costs: A v, A' w, P v, and one full normal-operator
     application M v = P v + sigma v + A'(rho A v) (the unit of CG cost);
  2. the baseline solve (cg_rel 1e-4) -> ms/outer-iteration, implied inner
     CG iterations/outer;
  3. a sweep over cg_rel_eps (inexact-ADMM forcing) and Anderson memory —
     looser inner solves trade Krylov steps for outer iterations; the
     host-side KKT report keeps every row honest.

Writes a JSON artifact (default benchmarks/results/config4_large_sparse.json)
naming the device it ran on.

Ref: the reference routes this regime to PCG and reports solve time only
(/root/reference/SolveQuadraticProgram.m:190-204, 249-250); the budget
breakdown and forcing sweep are additions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--eps", type=float, default=1e-4)
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--storage", choices=("bcoo", "ell"), default="bcoo")
    p.add_argument("--cadence-probe", action="store_true",
                   help="run ONLY the check-interval probe (ci=25 baseline "
                        "vs ci=5 fine cadence) at the baseline forcing "
                        "config and fold the result into the existing "
                        "artifact — answers how much of the 150-iteration "
                        "count is exit granularity")
    p.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "results", "config4_large_sparse.json"))
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)
    from quadraticprogramsolver_tpu.models.scaling import (
        equilibrate_sparse_host,
    )
    from quadraticprogramsolver_tpu.problems.generator import (
        generate_large_sparse_qp,
    )
    from quadraticprogramsolver_tpu.utils.oracle import kkt_optimality

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}
    t0 = time.perf_counter()
    data = generate_large_sparse_qp(args.n, seed=0)
    Ps, qs, As, ls, us, scaling = equilibrate_sparse_host(
        data.P, data.q, data.A, data.l, data.u, 10)
    sqp = qps.make_sparse_qp(Ps, qs, As, ls, us, dtype=np.float32,
                             storage=args.storage)
    log(f"n={args.n} m={data.m} nnz(P)={data.P.nnz} nnz(A)={data.A.nnz} "
        f"prepared in {time.perf_counter()-t0:.1f}s on {jax.devices()[0]}")

    if args.cadence_probe:
        rows = []
        for ci in (25, 5):
            st = qps.Settings(max_iterations=args.iters, eps_abs=args.eps,
                              eps_rel=args.eps, rho=0.1, adaptive_rho=True,
                              cg_eps=1e-6, cg_max_iterations=200,
                              cg_rel_eps=1e-4, check_interval=ci)
            jax.block_until_ready(qps.solve_jit(sqp, st, scaling=scaling))
            t0 = time.perf_counter()
            sol = jax.block_until_ready(
                qps.solve_jit(sqp, st, scaling=scaling))
            dt = time.perf_counter() - t0
            row = {"check_interval": ci, "solve_s": dt,
                   "exit_iteration": int(sol.info.iterations),
                   "status": qps.Status(int(sol.info.status)).name,
                   "res_prim": float(sol.info.res_prim),
                   "res_dual": float(sol.info.res_dual)}
            rows.append(row)
            log(f"  ci={ci}: {dt:.1f} s, exit at iteration "
                f"{row['exit_iteration']}, status {row['status']}")
        path = args.out
        artifact = {}
        if os.path.exists(path):
            with open(path) as f:
                artifact = json.load(f)
        artifact["cadence_probe"] = rows
        artifact["cadence_probe_device"] = device
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(artifact, f, indent=1)
        print(json.dumps({"cadence_probe": rows}))
        return 0

    # ---- 1. matvec budget units ------------------------------------------
    # A single matvec is shorter than a dispatch: chain CHAIN dependent
    # applications inside ONE jitted program and divide.
    CHAIN = 16

    def time_op(name, fn, *fnargs, reps=5):
        @jax.jit
        def chained(v):
            for _ in range(CHAIN):
                v = fn(v)
            return v

        jax.block_until_ready(chained(*fnargs))
        dt = None
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(chained(*fnargs))
            t = time.perf_counter() - t0
            dt = t if dt is None else min(dt, t)
        dt = dt / CHAIN
        log(f"  {name:24s}: {dt*1e3:7.1f} ms (chained x{CHAIN})")
        return dt

    v = jnp.asarray(np.random.default_rng(0).standard_normal(args.n), jnp.float32)
    w = jnp.asarray(np.random.default_rng(1).standard_normal(data.m), jnp.float32)
    sigma = jnp.float32(1e-6)
    rho = jnp.float32(0.1)
    mv = {}
    mv["AtA"] = time_op("A'(A v)", lambda v: sqp.matvec_At(sqp.matvec_A(v)), v)
    mv["P"] = time_op("P v", sqp.matvec_P, v)
    mv["normal_op"] = time_op(
        "M v (P+sigma+A'rhoA)",
        lambda v: sqp.matvec_P(v) + sigma * v
        + sqp.matvec_At(rho * sqp.matvec_A(v)), v)

    # ---- 2+3. solve sweep over inner forcing ------------------------------
    # Each config is a separate compiled program.
    configs = [
        {"label": "baseline cg_rel=1e-4", "cg_rel_eps": 1e-4, "anderson": 0},
        {"label": "loose cg_rel=1e-3", "cg_rel_eps": 1e-3, "anderson": 0},
        {"label": "looser cg_rel=3e-3", "cg_rel_eps": 3e-3, "anderson": 0},
        {"label": "loose + anderson8", "cg_rel_eps": 1e-3, "anderson": 8},
    ]
    rows = []
    for cfg in configs:
        st = qps.Settings(max_iterations=args.iters, eps_abs=args.eps,
                          eps_rel=args.eps, rho=0.1, adaptive_rho=True,
                          cg_eps=1e-6, cg_max_iterations=200,
                          cg_rel_eps=cfg["cg_rel_eps"],
                          anderson_memory=cfg["anderson"])
        jax.block_until_ready(qps.solve_jit(sqp, st, scaling=scaling))
        t0 = time.perf_counter()
        sol = jax.block_until_ready(qps.solve_jit(sqp, st, scaling=scaling))
        dt = time.perf_counter() - t0
        iters = int(sol.info.iterations)
        xs = np.asarray(sol.x, np.float64)
        zs = np.asarray(sol.z, np.float64)
        ys = np.asarray(sol.y, np.float64)
        rep = kkt_optimality(data.P, data.q, data.A, data.l, data.u,
                             xs, zs, ys)
        # The solver's own termination test (OSQP relative criterion),
        # re-evaluated in f64 on the ORIGINAL unscaled problem — the honest
        # "did it really converge to eps" check (an absolute bar is
        # meaningless at this problem's O(1e2) residual scales).
        Ax = data.A @ xs
        Px = data.P @ xs
        Aty = data.A.T @ ys
        eps_p = args.eps + args.eps * max(np.abs(Ax).max(), np.abs(zs).max())
        eps_d = args.eps + args.eps * max(np.abs(Px).max(), np.abs(Aty).max(),
                                          np.abs(data.q).max())
        osqp_pass = bool((rep.res_prim <= eps_p) and (rep.res_dual <= eps_d))
        row = {
            **cfg,
            "status": qps.Status(int(sol.info.status)).name,
            "solve_s": dt,
            "outer_iterations": iters,
            "ms_per_outer_iteration": dt * 1e3 / max(iters, 1),
            "iterations_per_s": iters / dt,
            "implied_inner_cg_per_outer":
                (dt / max(iters, 1)) / mv["normal_op"] - 1.0,
            "kkt_host": {"prim": rep.res_prim, "dual": rep.res_dual,
                         "comp": rep.res_comp},
            "eps_prim": eps_p, "eps_dual": eps_d,
            "osqp_criterion_pass_f64": osqp_pass,
        }
        rows.append(row)
        log(f"  {cfg['label']:24s}: {dt:6.1f} s, {iters} iters, "
            f"{row['ms_per_outer_iteration']:.0f} ms/iter, "
            f"~{row['implied_inner_cg_per_outer']:.1f} CG/outer, "
            f"status {row['status']}, kkt prim {rep.res_prim:.1e} "
            f"dual {rep.res_dual:.1e}")

    solved = [r for r in rows if r.get("status") in ("SOLVED", "SOLVED_ADMM")
              and r.get("osqp_criterion_pass_f64")]
    best = min(solved, key=lambda r: r["solve_s"]) if solved else None
    artifact = {
        "benchmark": "config4_large_sparse",
        **device,
        "n": args.n, "m": data.m,
        "nnz_P": int(data.P.nnz), "nnz_A": int(data.A.nnz),
        "storage": args.storage,
        "matvec_ms": {k: v * 1e3 for k, v in mv.items()},
        "rows": rows,
        "best": best,
    }
    path = args.out
    # A full re-run must not drop the cadence-probe section (written by
    # --cadence-probe into the same artifact).
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        if "cadence_probe" in old:
            artifact["cadence_probe"] = old["cadence_probe"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({k: artifact[k] for k in
                      ("benchmark", "n", "matvec_ms", "best")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
