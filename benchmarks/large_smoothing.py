"""Large-scale monotone-spline smoothing through matrix-free sparse ProxQP.

The reference's flagship ProxQP application (ProxQP002.jl:131-212, a
monotone exchange-rate smoother) at n >= 5e4 — the scale its dense CHOLMOD
constructor cannot reach and the matrix-free CG path exists for.

    python benchmarks/large_smoothing.py [--n 50000] [--f32]

Measured (CPU f64, n=5e4, eps 1e-6): plain prox-ALM exhausts a
2000-iteration budget (residuals ~7e-6), Anderson(8) converges in 1800;
both produce exactly piecewise-monotone signals.

``--f32`` runs in float32 on the default device (the GPU where there is
one) at eps 1e-5 / 400 iterations: the squared difference operator's
conditioning makes this a stress case for f32, so the 1e-6-accurate
monotone result is the f64 configuration.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--f32", action="store_true",
                    help="float32 on the default device")
    ap.add_argument("--storage", choices=("ell", "bcoo"), default="ell")
    args = ap.parse_args()

    import jax

    if not args.f32:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import scipy.sparse as sp

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.models import proxqp
    from quadraticprogramsolver_tpu.problems.operators import (
        monotone_smoothing_sparse_qp)
    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()

    n = args.n
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, n)
    y = np.sin(np.pi * t) + 0.05 * rng.standard_normal(n)
    ref_idx = np.array([0, n // 2, n - 1])
    P, q, C, d = monotone_smoothing_sparse_qp(y, ref_idx, smooth_order=2,
                                              lam=50.0)
    A = sp.csr_matrix(([1.0], ([0], [0])), shape=(1, n))  # pin x[0] = y[0]
    b = np.array([y[0]])
    print(f"n={n}: P nnz {P.nnz}, C rows {C.shape[0]}", flush=True)
    dtype = np.float32 if args.f32 else np.float64
    sprob = qps.make_sparse_proxqp(P, q, A, b, C, d, dtype=dtype,
                                   storage=args.storage)
    for mem in (0, 8):
        # cg_rel_eps: the squared difference operator makes an absolute
        # f32 inner tolerance unreachable — without the relative forcing
        # term every outer iteration burns the full cg budget. f32 + the
        # operator's conditioning put the practical target at eps 1e-5 /
        # 400 iterations (the 1e-6 full-budget run is the f64
        # configuration).
        if args.f32:
            st = qps.ProxQPSettings(max_iterations=400, eps_abs=1e-5,
                                    eps_rel=1e-5, cg_eps=1e-10,
                                    cg_max_iterations=300,
                                    anderson_memory=mem, cg_rel_eps=1e-4)
        else:
            st = qps.ProxQPSettings(max_iterations=2000, eps_abs=1e-6,
                                    eps_rel=1e-6, cg_eps=1e-10,
                                    cg_max_iterations=300,
                                    anderson_memory=mem)
        t0 = time.time()
        sol = jax.block_until_ready(proxqp.solve_jit(sprob, st))
        x = np.asarray(sol.x, np.float64)
        half = n // 2
        mono = bool((np.diff(x[: half + 1]) >= -1e-6).all()
                    and (np.diff(x[half:]) <= 1e-6).all())
        print(f"mem={mem}: status={int(sol.info.status)} "
              f"iters={int(sol.info.iterations)} t={time.time()-t0:.0f}s "
              f"rp={float(sol.info.res_prim):.1e} "
              f"rd={float(sol.info.res_dual):.1e} monotone={mono}", flush=True)


if __name__ == "__main__":
    main()
