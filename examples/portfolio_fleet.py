"""Example: solve a fleet of portfolio-optimization QPs on one device.

The reference solves one portfolio instance at a time
(GenerateQuadraticProgram.jl:37-47 builds it; RunTests.jl solves it); the
batched workflow solves hundreds of scenarios in one compiled program.

    python examples/portfolio_fleet.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import quadraticprogramsolver_tpu as qps  # noqa: E402


def main():
    fleet_size, assets = 128, 100
    fleet = qps.generate_batch(
        qps.ProblemClass.PORTFOLIO, batch=fleet_size, num_elements=assets,
        seed=7, dtype=np.float32)
    print(f"fleet: {fleet_size} portfolio QPs, {fleet.n} vars x {fleet.m} constraints")

    settings = qps.Settings(
        eps_abs=1e-5, eps_rel=1e-5, rho=0.1, adaptive_rho=True,
        max_iterations=4000)
    sol = qps.solve_jit(fleet, settings)

    status = np.asarray(sol.info.status)
    iters = np.asarray(sol.info.iterations)
    print(f"solved {int((status >= 2).sum())}/{fleet_size} "
          f"(iterations p50 {np.median(iters):.0f}, max {iters.max()})")

    # First `assets` variables are the asset weights; they obey the simplex
    # constraints the portfolio class encodes (sum = 1, 0 <= w <= 1).
    w = np.asarray(sol.x)[:, :assets]
    print(f"weight sums: min {w.sum(axis=1).min():.6f} max {w.sum(axis=1).max():.6f}")
    print(f"objective range: [{np.asarray(sol.info.objective).min():.4f}, "
          f"{np.asarray(sol.info.objective).max():.4f}]")


if __name__ == "__main__":
    main()
