"""Example: safeguarded Anderson acceleration on a slow-converging fleet.

The inequality-heavy OSQP-paper family (m = 10n dense rows) is the measured
worst case for plain ADMM at tight tolerances: stragglers need 1000+
iterations. `Settings.anderson_memory` turns on guarded type-II Anderson
acceleration of the fixed point (models/anderson.py) — per-lane, safeguarded
so it can never lose to the plain iteration — and roughly halves the
straggler iteration counts.

    python examples/anderson_acceleration.py [--f32]

Runs in f64 on the CPU by default; --f32 runs it in float32 on the default
device (the GPU where there is one).
"""

import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    f32 = "--f32" in sys.argv
    import jax

    if not f32:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    dtype = np.float32 if f32 else np.float64
    batch, n = 32, 100
    fleet = qps.generate_batch(qps.ProblemClass.INEQUALITY_QP, batch, n,
                               seed=0, dtype=dtype)
    base = qps.Settings(eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
                        max_iterations=4000, check_interval=25)

    for mem in (0, 8):
        st = dataclasses.replace(base, anderson_memory=mem)
        t0 = time.time()
        sol = qps.solve_jit(fleet, st)
        iters = np.asarray(sol.info.iterations)
        status = np.asarray(sol.info.status)
        solved = int(((status == 2) | (status == 3)).sum())
        label = f"anderson_memory={mem}" if mem else "plain ADMM        "
        print(f"{label}: solved {solved}/{batch}, iterations "
              f"p50={int(np.median(iters))} max={int(iters.max())} "
              f"total={int(iters.sum())}  ({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
