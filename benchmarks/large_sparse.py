"""Large sparse QP via matrix-free PCG — BASELINE.md config 4 (n=1e5 scale).

    python benchmarks/large_sparse.py [--n 100000]

Solves one n-variable sparse QP with the matrix-free Jacobi-PCG KKT backend
under the ADMM core (never materializing the normal matrix), then verifies
KKT optimality host-side and prints timing.

Defaults:
  * storage="bcoo" (`--storage ell` keeps the padded-row gather layout);
  * one monolithic in-program adaptive-rho solve. `--segmented` runs bounded
    device segments with host-side rho adaptation instead — the way to
    checkpoint very long solves.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--eps", type=float, default=1e-4)
    # 300: converges at 150 with scaling.
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--no-scaling", action="store_true",
                   help="skip the host-side Ruiz pre-scaling")
    p.add_argument("--cg-rel", type=float, default=1e-4,
                   help="relative inner CG tolerance (0 = fixed abstol)")
    p.add_argument("--ci", type=int, default=25,
                   help="convergence-check cadence (Settings.check_interval;"
                        " a fine cadence reveals the exact exit iteration — "
                        "the config-4 exit-granularity probe)")
    p.add_argument("--storage", choices=("bcoo", "ell"), default="bcoo")
    p.add_argument("--segmented", action="store_true",
                   help="bounded device segments + host-side rho adaptation "
                        "(the checkpointable path)")
    p.add_argument("--mesh", type=int, default=0, metavar="D",
                   help="row-shard the problem over a D-device mesh "
                        "(parallel/sparse_mesh.py); on a 1-chip host run "
                        "under XLA_FLAGS=--xla_force_host_platform_device_"
                        "count=D JAX_PLATFORMS=cpu to exercise the sharding")
    args = p.parse_args(argv)

    import jax

    if args.mesh and os.environ.get("JAX_PLATFORMS", "") == "cpu":
        # The CPU exercise of the row-sharded path: D virtual devices (the
        # flag is read when the CPU backend initializes).
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.mesh}")
        print(f"(JAX_PLATFORMS=cpu: running on {args.mesh} virtual CPU "
              f"devices)")

    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.problems.generator import generate_large_sparse_qp
    from quadraticprogramsolver_tpu.utils.oracle import kkt_optimality

    t0 = time.perf_counter()
    data = generate_large_sparse_qp(args.n, seed=0)
    print(f"generated n={args.n} m={data.m} nnz(P)={data.P.nnz} "
          f"nnz(A)={data.A.nnz} in {time.perf_counter()-t0:.1f}s "
          f"(device {jax.devices()[0]})")

    scaling = None
    if not args.no_scaling:
        # Host-side Ruiz pre-scaling (OSQP §5.1): the ELL container stores
        # the scaled problem; termination still runs on unscaled residuals
        # (solve(scaling=...)). On badly-scaled sparse instances this cuts
        # iterations by orders of magnitude (tests/test_scaling.py).
        from quadraticprogramsolver_tpu.models.scaling import (
            equilibrate_sparse_host)

        t0 = time.perf_counter()
        Ps, qs, As, ls, us, scaling = equilibrate_sparse_host(
            data.P, data.q, data.A, data.l, data.u, 10)
        print(f"ruiz pre-scaling (10 sweeps) in {time.perf_counter()-t0:.1f}s")
        sqp = qps.make_sparse_qp(Ps, qs, As, ls, us, dtype=np.float32,
                                 storage=args.storage)
    else:
        sqp = qps.make_sparse_qp(data.P, data.q, data.A, data.l, data.u,
                                 dtype=np.float32, storage=args.storage)
    st = qps.Settings(max_iterations=args.iters, eps_abs=args.eps,
                      eps_rel=args.eps, rho=0.1, adaptive_rho=True,
                      cg_eps=1e-6, cg_max_iterations=200,
                      cg_rel_eps=args.cg_rel, check_interval=args.ci)

    if args.mesh:
        from quadraticprogramsolver_tpu.parallel.sparse_mesh import (
            shard_sparse_qp, solve_sparse_mesh)

        if args.storage != "ell":
            print("(--mesh uses the ELL row-shard layout; --storage ignored)")
        src = ((Ps, qs, As, ls, us) if scaling is not None
               else (data.P, data.q, data.A, data.l, data.u))
        t0 = time.perf_counter()
        ssq = shard_sparse_qp(*src, args.mesh, dtype=np.float32,
                              scaling=scaling)
        print(f"sharded over {args.mesh} devices in "
              f"{time.perf_counter()-t0:.1f}s")
        run = lambda: solve_sparse_mesh(ssq, st, m_orig=data.m,
                                        scaling=scaling)
    elif args.segmented:
        from quadraticprogramsolver_tpu.models.admm import solve_segmented

        # Bounded device programs with the adaptive-rho update on the HOST
        # between segments (candidate + hysteresis at segment cadence) —
        # the checkpointable long-solve path.
        kw = dict(segment_iterations=100,
                  host_rho_adaptation=args.n >= 100_000, scaling=scaling)
        run = lambda: solve_segmented(sqp, st, **kw)
    else:
        run = lambda: qps.solve_jit(sqp, st, scaling=scaling)
    jax.block_until_ready(run())
    times = []
    for _ in range(1):
        t0 = time.perf_counter()
        sol = jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    print(f"solve: {min(times)*1e3:.0f} ms, status "
          f"{qps.Status(int(sol.info.status)).name}, "
          f"iterations {int(sol.info.iterations)}, "
          f"res_prim {float(sol.info.res_prim):.2e}, "
          f"res_dual {float(sol.info.res_dual):.2e}")

    rep = kkt_optimality(data.P, data.q, data.A, data.l, data.u,
                         np.asarray(sol.x), np.asarray(sol.z),
                         np.asarray(sol.y))
    print(f"KKT: prim {rep.res_prim:.2e} dual {rep.res_dual:.2e} "
          f"comp {rep.res_comp:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
