"""Example: a sharded fleet of split-form QPs on the prox-ALM family.

The second solver family (`/root/reference/ProxQP.jl:118-173`): a fleet of
dense `min 0.5 x'Px + q'x s.t. Ax=b, Cx<=d` problems drawn on the device
(problems/generator.device_split_qp_fleet), solved batched and sharded over
the device mesh (parallel/mesh.solve_prox_fleet) with the sigma-free column
cache and the static rho of ``chip_smoke.prox_headline_settings``.

Routing note: equality-heavy split problems belong on THIS family —
lowering them to box form and running the box headline stack converges
0/4096 lanes at typical rho (scalar-rho ADMM degrades on hard equality
rows; prox-ALM handles them exactly).

    python examples/prox_fleet.py           # small fleet, any device
    python examples/prox_fleet.py --full    # B=4096, n=512, n_eq=n_ineq=128
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    import quadraticprogramsolver_tpu as qps
    from chip_smoke import prox_headline_settings
    from quadraticprogramsolver_tpu.parallel.mesh import make_fleet_mesh
    from quadraticprogramsolver_tpu.problems.generator import (
        device_split_qp_fleet)
    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    full = "--full" in sys.argv[1:]
    B, n, me, mi = (4096, 512, 128, 128) if full else (32, 64, 8, 16)
    prob = device_split_qp_fleet(B, n, me, mi, seed=0)
    st = prox_headline_settings()
    mesh = make_fleet_mesh()

    # Shard ONCE (solve_prox_fleet would re-device_put the multi-GiB fleet
    # inside every call); repeated solves then go straight to the jitted
    # SPMD program.
    from quadraticprogramsolver_tpu.parallel.mesh import shard_fleet

    prob = shard_fleet(prob, mesh)
    jax.block_until_ready(qps.solve_proxqp_jit(prob, st))
    dt = None
    for _ in range(3):
        t0 = time.perf_counter()
        sol = jax.block_until_ready(qps.solve_proxqp_jit(prob, st))
        t = time.perf_counter() - t0
        dt = t if dt is None else min(dt, t)

    conv = int(np.asarray(sol.info.converged).sum())
    iters = np.asarray(sol.info.iterations)
    print(f"mesh: {mesh.devices.size} device(s); fleet B={B}, n={n}, "
          f"eq={me}, ineq={mi}")
    print(f"solved {conv}/{B} in {dt*1e3:.0f} ms ({conv/dt:.0f} solves/s), "
          f"iters p50={np.median(iters):.0f} max={iters.max()}")
    # Feasibility spot check on one lane.
    i = 0
    x = np.asarray(sol.x[i], np.float64)
    eq = np.abs(np.asarray(prob.A[i], np.float64) @ x
                - np.asarray(prob.b[i], np.float64)).max()
    ineq = (np.asarray(prob.C[i], np.float64) @ x
            - np.asarray(prob.d[i], np.float64)).max()
    print(f"lane 0 feasibility: |Ax-b|_inf = {eq:.2e}, max(Cx-d) = {ineq:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
