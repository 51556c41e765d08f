"""Headline benchmark: converged 512-variable QPs solved per second on one GPU.

    python bench.py

Prints ONE JSON line on stdout (diagnostics go to stderr):
    {"metric": ..., "value": N, "unit": "solves/sec/chip", "vs_baseline": N,
     ..., "platform": "gpu", "device_kind": ..., "device_count": ...,
     "card": "<name>, <power limit>"}

Baseline (BASELINE.md): >= 1000 batched 500-var QPs solved/sec/chip at 1e-4
accuracy. vs_baseline = value / 1000.

Protocol:
  * one fleet of B=4096 random_qp instances (n=512, m=256 — the OSQP-paper
    n/2 ratio, and strictly more work than the 500-var target) drawn on the
    device with the reference generator's distribution
    (problems.generator.device_random_qp_fleet);
  * solved by ``solve_jit`` at eps 1e-4 with the tuned stack of
    ``chip_smoke.headline_settings`` (rho 0.4 static, check_interval 11,
    sigma-free RHS, no refinement) — compiled and warmed up first, then the
    best of 3 solves, each ended by ``block_until_ready``;
  * only lanes ending SOLVED/SOLVED_ADMM count;
  * accuracy audit: 16 lanes (8 spread, 8 slowest) against the host f64
    oracle; the run fails if any is off by more than 1e-4.

There is no fallback: without a GPU the script exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_SOLVES_PER_SEC = 1000.0
BATCH, N, M, SEED = 4096, 512, 256, 1234


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    from chip_smoke import (AUDIT_TOL, audit_box, card_line, check,
                            converged_mask, headline_settings, pick_lanes,
                            require_gpu)

    devs = require_gpu()

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.problems.generator import (
        device_random_qp_fleet)
    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    card = card_line()
    log(f"device: {devs[0].platform} {devs[0].device_kind} x{len(devs)}; "
        f"card: {card}")
    settings = headline_settings()

    t0 = time.perf_counter()
    qp = jax.block_until_ready(device_random_qp_fleet(BATCH, N, M, SEED))
    log(f"B={BATCH}: generated on device in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jax.block_until_ready(qps.solve_jit(qp, settings))
    compile_s = time.perf_counter() - t0

    dt = None
    for _ in range(3):
        t0 = time.perf_counter()
        sol = jax.block_until_ready(qps.solve_jit(qp, settings))
        t = time.perf_counter() - t0
        dt = t if dt is None else min(dt, t)

    status = np.asarray(sol.info.status)
    iters = np.asarray(sol.info.iterations)
    solved = int(converged_mask(status).sum())
    rate = solved / dt
    log(f"B={BATCH}: {dt * 1e3:.1f} ms, solved {solved}/{BATCH}, iterations "
        f"p50={np.median(iters):.0f} max={iters.max()}, {rate:.0f} solves/s")

    lanes = pick_lanes(status, iters, 8, 8)
    audit = audit_box(qp, sol.x, lanes)
    log(f"accuracy audit: max|x-x_ref|_inf over {len(lanes)} lanes = "
        f"{audit:.3e}")
    check(audit <= AUDIT_TOL, f"audit {audit:.3e} > {AUDIT_TOL}")

    print(json.dumps({
        "metric": "batched 512-var QPs solved/sec/chip at 1e-4",
        "value": float(rate),
        "unit": "solves/sec/chip",
        "vs_baseline": float(rate) / BASELINE_SOLVES_PER_SEC,
        "batch": BATCH, "n": N, "m": M, "seed": SEED,
        "solve_ms": dt * 1e3,
        "compile_and_first_solve_s": compile_s,
        "solved": solved,
        "iterations_p50": float(np.median(iters)),
        "iterations_max": int(iters.max()),
        "audit_n": len(lanes),
        "audit_max_dev": audit,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
