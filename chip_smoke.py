#!/usr/bin/env python3
"""Run the solver's main paths once on the GPU and check every result.

    python chip_smoke.py                 # one card: phases 0-5
    python chip_smoke.py --trace DIR     # also trace phase 1 into DIR and
                                         # print device time per scope
    python chip_smoke.py --four          # four cards: the mesh phase only

Phases (one card), each through the public entry points and each checked
against the host float64 oracle (``utils/oracle.py``):

0. device: the first JAX device must be a GPU; prints the card's name and
   power limit, and checks that ``matmul_precision="highest"`` gives FP32
   (not TF32) products.
1. box fleet, headline shape: B=4096 random QPs, n=512, m=256, float32,
   drawn on the device, solved by ``solve_jit`` at eps 1e-4 with the tuned
   stack (rho 0.4 static, check_interval 11, sigma-free RHS, no
   refinement). 16 lanes audited (8 spread, 8 slowest).
2. the same family at default ``Settings`` (eps 1e-4, B=2048), 8 lanes.
3. prox fleet: B=4096, n=512, n_eq=n_ineq=128, sigma-free, static rho
   0.0125 (``solve_proxqp_jit``), 8 lanes audited on the box lowering.
4. factor reuse: ``CachedQPSolver`` ticks (``update(q=...)`` then
   ``solve(warm_start=True)``), each against a fresh ``solve_jit`` of the
   same data and 4 oracle lanes.
5. one sparse QP with n=1e5 (BCOO storage, matrix-free Jacobi-PCG, host
   Ruiz scaling), the OSQP termination criterion re-checked in float64.

``--four`` runs only the mesh phase: ``solve_fleet`` and
``solve_prox_fleet`` over four cards against single-card solves of the same
fleets, and ``solve_block_split`` of one INEQUALITY_QP against its
single-card solve.

A failed check raises and the script exits non-zero. The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: Audit bar: max |x - x_ref|_inf against the f64 oracle per audited lane.
AUDIT_TOL = 1e-4
#: Share of fleet lanes that must end SOLVED / SOLVED_ADMM (status 2 or 3).
MIN_CONVERGED = 0.99
#: Sharded vs single-card solves of one fleet: same math, other reduction
#: order, so they agree to f32 rounding carried through the iteration.
MESH_TOL = 1e-5


class SmokeFailure(AssertionError):
    """A phase's result is wrong."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    """``name, power.limit`` of every card, from nvidia-smi (a child
    process that never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu():
    """The JAX devices, after checking the first one is a GPU."""
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is {devs[0].platform} "
          f"({devs[0].device_kind})")
    return devs


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def converged_mask(status) -> np.ndarray:
    status = np.asarray(status)
    return (status == 2) | (status == 3)


def pick_lanes(status, iters, spread: int, slowest: int) -> list:
    """``spread`` converged lanes evenly spaced plus the ``slowest``
    converged lanes by iteration count (where inaccuracy hides)."""
    conv = np.nonzero(converged_mask(status))[0]
    iters = np.asarray(iters)
    lanes = set(conv[:: max(1, len(conv) // max(spread, 1))][:spread].tolist())
    if slowest:
        lanes |= set(conv[np.argsort(iters[conv])[-slowest:]].tolist())
    return sorted(lanes)


def oracle_dev(P, q, A, l, u, x) -> float:
    """|x - x_ref|_inf against the f64 oracle for one lane."""
    from quadraticprogramsolver_tpu.utils.oracle import solve_qp_reference

    ref = solve_qp_reference(
        np.asarray(P, np.float64), np.asarray(q, np.float64),
        np.asarray(A, np.float64), np.asarray(l, np.float64),
        np.asarray(u, np.float64), eps_abs=1e-6, eps_rel=1e-6, rho=0.1,
        max_iterations=20_000, linsys="splu")
    check(ref.status in (2, 3), f"oracle did not converge (status "
                                f"{ref.status})")
    return float(np.abs(np.asarray(x, np.float64) - ref.x).max())


def audit_box(qp, x, lanes) -> float:
    """Max oracle deviation over ``lanes`` of a batched box QP."""
    x = np.asarray(x)
    return max(oracle_dev(qp.P[i], qp.q[i], qp.A[i], qp.l[i], qp.u[i], x[i])
               for i in lanes)


def fleet_report(label, status, iters) -> float:
    status = np.asarray(status)
    iters = np.asarray(iters)
    share = float(converged_mask(status).mean())
    log(f"[{label}] converged {int(converged_mask(status).sum())}/"
        f"{status.size} ({share:.4f}), iterations p50 "
        f"{np.median(iters):.0f} max {int(iters.max())}")
    return share


def memory_report(label, compiled) -> dict:
    import jax

    ma = compiled.memory_analysis()
    rep = {}
    if ma is not None:
        rep = {k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}
    stats = jax.devices()[0].memory_stats() or {}
    rep["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    log(f"[{label}] memory: {rep}")
    return rep


def timed(fn, *args):
    """(result, seconds) of one call, waited for on the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def headline_settings():
    """The tuned box-fleet stack of phase 1 (and of ``bench.py``)."""
    import quadraticprogramsolver_tpu as qps

    return qps.Settings(
        max_iterations=2000, eps_abs=1e-4, eps_rel=1e-4, rho=0.4,
        adaptive_rho=False, check_interval=11, kkt_refinement_steps=0,
        sigma_free_rhs=True)


def prox_headline_settings():
    import quadraticprogramsolver_tpu as qps

    return qps.ProxQPSettings(
        max_iterations=2000, eps_abs=5e-5, eps_rel=5e-5, rho=0.0125,
        adaptive_rho=False, kkt_warm_start=False, kkt_refinement_steps=0,
        check_interval=25, sigma_free_rhs=True)


def precision_label(st) -> str:
    factor = getattr(st, "factor_precision", None) or getattr(
        st, "matmul_precision", "highest")
    return (f"matmul_precision={getattr(st, 'matmul_precision', 'highest')}"
            f" factor_precision={factor}")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_precision(n: int = 512, seed: int = 0) -> float:
    """A float32 product at matmul precision "highest" against float64:
    FP32 keeps ~1e-7 relative, TF32 only ~1e-3."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        c = np.asarray(jax.jit(jnp.matmul)(a, b), np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rel = float(np.abs(c - ref).max() / np.abs(ref).max())
    log(f"[precision] f32 {n}x{n} product at 'highest' vs f64: "
        f"max rel err {rel:.3e}")
    check(rel <= 1e-5, f"matmul precision 'highest' is not FP32 "
                       f"(rel err {rel:.3e})")
    return rel


def phase_box(label, batch, n, m, settings, spread, slowest, seed=1234,
              trace_dir=None) -> dict:
    """A device-drawn random-QP fleet through ``solve_jit``, audited."""
    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.problems.generator import (
        device_random_qp_fleet)

    qp, t_gen = timed(device_random_qp_fleet, batch, n, m, seed)
    log(f"[{label}] fleet B={batch} n={n} m={m} drawn on device in "
        f"{t_gen:.1f} s; {precision_label(settings)}")
    t0 = time.perf_counter()
    compiled = qps.solve_jit.lower(qp, settings).compile()
    log(f"[{label}] compiled in {time.perf_counter() - t0:.1f} s")
    sol, t_first = timed(qps.solve_jit, qp, settings)
    sol, t_solve = timed(qps.solve_jit, qp, settings)
    log(f"[{label}] solve {t_solve * 1e3:.1f} ms (first call "
        f"{t_first * 1e3:.1f} ms)")
    mem = memory_report(label, compiled)
    share = fleet_report(label, sol.info.status, sol.info.iterations)
    scopes = None
    if trace_dir is not None:
        scopes = trace_scopes(label, trace_dir, compiled.as_text(),
                              lambda: qps.solve_jit(qp, settings))
    lanes = pick_lanes(sol.info.status, sol.info.iterations, spread, slowest)
    dev = audit_box(qp, sol.x, lanes)
    log(f"[{label}] oracle audit over {len(lanes)} lanes: max|x-x_ref| "
        f"{dev:.3e}")
    check(share >= MIN_CONVERGED, f"[{label}] only {share:.4f} converged")
    check(dev <= AUDIT_TOL, f"[{label}] audit {dev:.3e} > {AUDIT_TOL}")
    return {"converged": share, "audit": dev, "lanes": len(lanes),
            "solve_s": t_solve, "memory": mem, "scopes": scopes}


def trace_scopes(label, trace_dir, hlo_text, run) -> dict:
    """Trace one call of ``run`` and reduce it to device time per scope."""
    import jax

    from quadraticprogramsolver_tpu.utils import profiling

    plane = "/device:GPU" if jax.devices()[0].platform == "gpu" else "/host:CPU"
    with profiling.trace(trace_dir):
        jax.block_until_ready(run())
    times = profiling.scope_device_times(trace_dir, hlo_text, plane)
    log(f"[{label}] device seconds per scope: "
        + ", ".join(f"{k} {v:.6f}" for k, v in times.items()))
    return times


def phase_prox(batch, n, me, mi, spread=4, slowest=4, seed=0) -> dict:
    """A device-drawn split-form fleet through ``solve_proxqp_jit``."""
    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.problems.generator import (
        device_split_qp_fleet)

    st = prox_headline_settings()
    prob, t_gen = timed(device_split_qp_fleet, batch, n, me, mi, seed)
    log(f"[prox] fleet B={batch} n={n} n_eq={me} n_ineq={mi} drawn in "
        f"{t_gen:.1f} s; {precision_label(st)}")
    compiled = qps.solve_proxqp_jit.lower(prob, st).compile()
    sol, _ = timed(qps.solve_proxqp_jit, prob, st)
    sol, t_solve = timed(qps.solve_proxqp_jit, prob, st)
    log(f"[prox] solve {t_solve * 1e3:.1f} ms")
    mem = memory_report("prox", compiled)
    share = fleet_report("prox", sol.info.status, sol.info.iterations)
    lanes = pick_lanes(sol.info.status, sol.info.iterations, spread, slowest)
    dev = audit_box(prob.to_box_qp(), sol.x, lanes)
    log(f"[prox] oracle audit over {len(lanes)} lanes: max|x-x_ref| "
        f"{dev:.3e}")
    check(share >= MIN_CONVERGED, f"[prox] only {share:.4f} converged")
    check(dev <= AUDIT_TOL, f"[prox] audit {dev:.3e} > {AUDIT_TOL}")
    return {"converged": share, "audit": dev, "lanes": len(lanes),
            "solve_s": t_solve, "memory": mem}


def phase_reuse(batch, n, m, ticks=3, oracle_lanes=4, seed=7) -> dict:
    """``CachedQPSolver`` MPC-style ticks against fresh solves."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.problems.generator import (
        device_random_qp_fleet)

    # Tighter than the 1e-4 comparison bar: the warm tick and the cold
    # fresh solve stop at different points inside the eps ball.
    st = dataclasses.replace(headline_settings(), eps_abs=1e-5, eps_rel=1e-5,
                             max_iterations=4000)
    qp = device_random_qp_fleet(batch, n, m, seed)
    log(f"[reuse] fleet B={batch} n={n} m={m}; {precision_label(st)}")
    solver = qps.CachedQPSolver(qp, st)
    solver.solve()
    worst_fresh = worst_oracle = 0.0
    for t in range(ticks):
        q = qp.q + 0.05 * jax.random.normal(jax.random.PRNGKey(100 + t),
                                            qp.q.shape, jnp.float32)
        solver.update(q=q)
        tick, t_tick = timed(lambda: solver.solve(warm_start=True))
        fresh, t_fresh = timed(qps.solve_jit, solver.qp, st)
        share = fleet_report(f"reuse tick {t}", tick.info.status,
                             tick.info.iterations)
        check(share >= MIN_CONVERGED, f"[reuse] tick {t}: only {share:.4f} "
                                      "converged")
        d_fresh = float(np.abs(np.asarray(tick.x)
                               - np.asarray(fresh.x)).max())
        lanes = pick_lanes(tick.info.status, tick.info.iterations,
                           oracle_lanes, 0)
        d_oracle = audit_box(solver.qp, tick.x, lanes)
        log(f"[reuse] tick {t}: {t_tick * 1e3:.1f} ms (fresh solve "
            f"{t_fresh * 1e3:.1f} ms), |tick - fresh| {d_fresh:.3e}, oracle "
            f"{d_oracle:.3e} over {len(lanes)} lanes")
        check(d_fresh <= AUDIT_TOL, f"[reuse] tick {t} vs fresh solve "
                                    f"{d_fresh:.3e}")
        check(d_oracle <= AUDIT_TOL, f"[reuse] tick {t} audit {d_oracle:.3e}")
        worst_fresh = max(worst_fresh, d_fresh)
        worst_oracle = max(worst_oracle, d_oracle)
    return {"vs_fresh": worst_fresh, "audit": worst_oracle}


def phase_sparse(n, eps=1e-4, storage="bcoo", seed=0) -> dict:
    """One large sparse QP: matrix-free PCG, host Ruiz scaling, and the
    OSQP termination criterion re-checked in float64 on the host."""
    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.models.scaling import (
        equilibrate_sparse_host)
    from quadraticprogramsolver_tpu.problems.generator import (
        generate_large_sparse_qp)

    t0 = time.perf_counter()
    data = generate_large_sparse_qp(n, seed=seed)
    Ps, qs, As, ls, us, scaling = equilibrate_sparse_host(
        data.P, data.q, data.A, data.l, data.u, 10)
    sqp = qps.make_sparse_qp(Ps, qs, As, ls, us, dtype=np.float32,
                             storage=storage)
    log(f"[sparse] n={n} m={data.m} nnz(P)={data.P.nnz} nnz(A)={data.A.nnz}"
        f" storage={storage}, set up on host in "
        f"{time.perf_counter() - t0:.1f} s")
    st = qps.Settings(max_iterations=300, eps_abs=eps, eps_rel=eps, rho=0.1,
                      cg_eps=1e-6, cg_max_iterations=200, cg_rel_eps=1e-4,
                      check_interval=25)
    solve = lambda: qps.solve_jit(sqp, st, scaling=scaling)
    sol, t_first = timed(solve)
    sol, t_solve = timed(solve)
    status = int(sol.info.status)
    log(f"[sparse] status {qps.Status(status).name}, iterations "
        f"{int(sol.info.iterations)}, solve {t_solve:.2f} s (first call "
        f"{t_first:.2f} s); {precision_label(st)}")
    x, z, y = (np.asarray(v, np.float64) for v in (sol.x, sol.z, sol.y))
    Ax, Px, Aty = data.A @ x, data.P @ x, data.A.T @ y
    inf = lambda v: float(np.abs(v).max())
    rp, rd = inf(Ax - z), inf(Px + data.q + Aty)
    tol_p = eps + eps * max(inf(Ax), inf(z))
    tol_d = eps + eps * max(inf(Px), inf(Aty), inf(data.q))
    log(f"[sparse] f64 residuals: prim {rp:.3e} (tol {tol_p:.3e}), dual "
        f"{rd:.3e} (tol {tol_d:.3e})")
    check(status in (2, 3), f"[sparse] status {status}")
    check(rp <= tol_p and rd <= tol_d, "[sparse] OSQP criterion fails in f64")
    return {"status": status, "res_prim": rp, "res_dual": rd,
            "solve_s": t_solve, "storage": storage}


def phase_mesh(devices, batch, n, m, prox_dims, block_n, seed=11) -> dict:
    """Fleet and block-split solves over ``devices`` against the same
    solves on the first device alone."""
    from jax.sharding import Mesh

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.parallel.consensus import (
        BLOCK_AXIS, solve_block_split)
    from quadraticprogramsolver_tpu.parallel.mesh import (
        make_fleet_mesh, solve_fleet, solve_prox_fleet)
    from quadraticprogramsolver_tpu.problems.generator import (
        device_random_qp_fleet, device_split_qp_fleet)

    k = len(devices)
    mesh = make_fleet_mesh(devices)
    out = {}

    def compare(label, single, sharded):
        spread = sharded.x.sharding.device_set
        log(f"[mesh {label}] x sharding: {sharded.x.sharding} on "
            f"{len(spread)} devices")
        check(len(spread) == k, f"[mesh {label}] x lives on {len(spread)} "
                                f"of {k} devices")
        dev = float(np.abs(np.asarray(single.x)
                           - np.asarray(sharded.x)).max())
        log(f"[mesh {label}] max|x_sharded - x_single| {dev:.3e}")
        check(dev <= MESH_TOL, f"[mesh {label}] deviation {dev:.3e}")
        out[label] = dev

    st = headline_settings()
    qp = device_random_qp_fleet(batch, n, m, seed)
    timed(qps.solve_jit, qp, st)
    single, t1 = timed(qps.solve_jit, qp, st)
    sharded, _ = timed(solve_fleet, qp, st, mesh)
    sharded, tk = timed(solve_fleet, qp, st, mesh)
    log(f"[mesh box] B={batch} n={n} m={m}: 1 card {t1 * 1e3:.1f} ms, "
        f"{k} cards {tk * 1e3:.1f} ms")
    fleet_report(f"mesh box x{k}", sharded.info.status,
                 sharded.info.iterations)
    compare("box", single, sharded)

    pst = prox_headline_settings()
    prob = device_split_qp_fleet(batch, *prox_dims, seed)
    timed(qps.solve_proxqp_jit, prob, pst)
    single, t1 = timed(qps.solve_proxqp_jit, prob, pst)
    sharded, _ = timed(solve_prox_fleet, prob, pst, mesh)
    sharded, tk = timed(solve_prox_fleet, prob, pst, mesh)
    log(f"[mesh prox] B={batch} dims={prox_dims}: 1 card {t1 * 1e3:.1f} ms,"
        f" {k} cards {tk * 1e3:.1f} ms")
    compare("prox", single, sharded)

    data = qps.generate_random_qp(qps.ProblemClass.INEQUALITY_QP, block_n,
                                  seed=seed)
    big = qps.make_qp(*data.dense(), dtype=np.float32)
    bst = qps.Settings(max_iterations=4000, eps_abs=1e-5, eps_rel=1e-5,
                       rho=0.1)
    single, t1 = timed(qps.solve_jit, big, bst)
    block_mesh = Mesh(np.asarray(devices), (BLOCK_AXIS,))
    split, tk = timed(solve_block_split, big, bst, block_mesh)
    log(f"[mesh block] INEQUALITY_QP n={big.n} m={big.m}: status single "
        f"{int(single.info.status)} split {int(split.info.status)}, "
        f"iterations {int(single.info.iterations)} / "
        f"{int(split.info.iterations)}, first calls (incl. compile) "
        f"{t1:.2f} s / {tk:.2f} s")
    check(int(split.info.status) in (2, 3), "[mesh block] not solved")
    dev = float(np.abs(np.asarray(single.x) - np.asarray(split.x)).max())
    log(f"[mesh block] max|x_split - x_single| {dev:.3e}")
    check(dev <= MESH_TOL, f"[mesh block] deviation {dev:.3e}")
    out["block"] = dev
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the mesh phase, on four cards")
    p.add_argument("--trace", metavar="DIR",
                   help="trace one phase-1 solve into DIR and print device "
                        "time per solver scope")
    args = p.parse_args(argv)

    try:
        devs = require_gpu()
    except SmokeFailure as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2

    from quadraticprogramsolver_tpu.utils.compile_cache import (
        enable_compile_cache)

    cache = enable_compile_cache()
    d0 = devs[0]
    log(f"device: {d0.platform} {d0.device_kind} x{len(devs)}; compile "
        f"cache {cache}")
    log(f"card: {card_line()}")

    if args.four:
        check(len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}")
        devs = devs[:4]
        phase_mesh(devs, 4096, 512, 256, (512, 128, 128), 1000)
    else:
        phase_precision()
        phase_box("box headline", 4096, 512, 256, headline_settings(),
                  spread=8, slowest=8, trace_dir=args.trace)
        import quadraticprogramsolver_tpu as qps

        phase_box("box defaults", 2048, 512, 256,
                  qps.Settings(max_iterations=2000, eps_abs=1e-4,
                               eps_rel=1e-4),
                  spread=4, slowest=4)
        phase_prox(4096, 512, 128, 128)
        phase_reuse(2048, 512, 256)
        phase_sparse(100_000)

    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
