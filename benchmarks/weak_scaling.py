"""Weak-scaling proxy: fleet wall-clock at 1/2/4 virtual CPU devices with
ONE PINNED PHYSICAL CORE PER DEVICE.

BASELINE.md's north star is >=80% weak-scaling efficiency at 2+ hosts. This
is the CPU stand-in measurement (the real one runs the fleet over four GPUs:
``python chip_smoke.py --four`` times it): the SAME SPMD fleet program
(parallel/mesh.solve_fleet) run over a D-device
`--xla_force_host_platform_device_count` CPU mesh with a FIXED per-device
load and the child process's CPU affinity restricted to exactly D cores
(os.sched_setaffinity BEFORE backend init — XLA's CPU client sizes its
thread pool from the schedulable-CPU count, so each virtual device
effectively owns one core). Weak-scaling efficiency is then the honest
wall-clock ratio T(1)/T(D), ideal 1.0.

An earlier version measured AGGREGATE THROUGHPUT on the shared-core host:
all virtual devices fought over the same cores and noise exceeded the
effect. With pinned cores, any efficiency below 1.0 is overhead the SPMD
program itself added with scale: sharding-induced copies, collective setup,
the predicate all-reduce (the fleet solve's only collective).

What it does NOT show: NVLink bandwidth or multi-host networking. On real
cards each device owns its compute by construction; flat pinned-core
efficiency here is the CPU-visible precondition for flat weak scaling
there.

Each shard holds the SAME problem block (the D=1 fleet tiled D times) so
per-device iteration counts are identical by construction — the weak-scaling
ideal — and the solved/unsolved mix cannot drift with D.

Writes benchmarks/results/weak_scaling.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

B_LOC = 64     # lanes per device (fixed: weak scaling)
N = 128
SEED = 0
REPS = 5


def child(n_devices: int, solo_core: int = -1, start_at: float = 0.0,
          ablate: bool = False) -> None:
    """Runs in a fresh process, print one JSON line.

    Three modes:
      * SPMD (solo_core < 0): D virtual CPU devices in ONE process, pinned
        to D cores — the sharded fleet program with its collective.
      * solo (solo_core >= 0): ONE device pinned to ONE core solving the
        same per-device load; the parent launches D of these concurrently
        (synchronized by ``start_at``) — true zero-communication weak
        scaling at the process level. The SPMD/solo wall ratio isolates
        what running it as one SPMD program costs (collectives + the XLA
        CPU runtime's intra-process device scheduling).
      * ablated (--ablate): the SAME one-process D-device program with the
        collective REMOVED — the solve runs under shard_map, so the
        while-loop predicate's jnp.any reduces over the LOCAL shard only
        (no cross-device all-reduce anywhere in the program). Because every
        shard holds the identical tiled block, the local predicate fires at
        exactly the same chunk as the global one: identical per-device
        work, zero communication. spmd/ablated isolates the collective's
        cost; ablated/solo isolates the XLA:CPU intra-process device
        scheduling cost (which does not exist on real chips).
    """
    # Affinity FIRST, before the CPU backend initializes: XLA's CPU client
    # sizes its compute pool from the schedulable-CPU count, so this both
    # pins the cores and right-sizes the thread pool to one core per
    # virtual device.
    if solo_core >= 0:
        os.sched_setaffinity(0, {solo_core})
        n_devices = 1
    else:
        os.sched_setaffinity(0, set(range(n_devices)))

    import jax

    # The device-count flag is read lazily at CPU-backend init, so setting
    # it here (before any computation) still takes.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_devices}")
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    import quadraticprogramsolver_tpu as qps
    from quadraticprogramsolver_tpu.parallel.mesh import (
        make_fleet_mesh,
        shard_fleet,
    )
    from quadraticprogramsolver_tpu.models.admm import solve_jit

    assert len(jax.devices()) == n_devices, jax.devices()
    base = qps.generate_batch(qps.ProblemClass.RANDOM_QP, B_LOC, N, seed=SEED)
    # Tile the one-device fleet D times: every shard computes the identical
    # block, so per-device work is exactly constant across D.
    qp = jax.tree.map(
        lambda x: np.tile(np.asarray(x, np.float32),
                          (n_devices,) + (1,) * (x.ndim - 1)),
        base)
    qp = qps.QP(P=qp.P, q=qp.q, A=qp.A, l=qp.l, u=qp.u)
    settings = qps.Settings(rho=0.1, eps_abs=1e-4, eps_rel=1e-4,
                            check_interval=25, max_iterations=2000)

    mesh = make_fleet_mesh()
    qp = shard_fleet(qp, mesh)

    if ablate:
        # Collective-free twin: shard_map makes the solve's while predicate
        # local to each shard. Same math, same chunk count (tiled blocks),
        # no all-reduce. jit(shard_map(solve)) so everything else lowers
        # identically.
        import functools

        from jax.sharding import PartitionSpec as P

        from quadraticprogramsolver_tpu.models import admm as admm_mod

        specs = (P("qp", None, None), P("qp", None), P("qp", None, None),
                 P("qp", None), P("qp", None))

        @jax.jit
        @functools.partial(jax.shard_map, mesh=mesh, in_specs=specs,
                           out_specs=(P("qp", None), P("qp")))
        def run(Pm, q, A, l, u):
            # Zero warm starts derived from the (varying) inputs so the
            # while-loop carry is uniformly varying over the shard axis.
            sol = admm_mod.solve(qps.QP(Pm, q, A, l, u), settings,
                                 x0=0.0 * q, z0=0.0 * l, y0=0.0 * l)
            return sol.x, sol.info.status

        def solve_fn(qp, _settings):
            x, status = run(qp.P, qp.q, qp.A, qp.l, qp.u)

            class _Sol:  # minimal duck-typed result for the timing below
                pass

            s = _Sol()
            s.x = x
            s.info = _Sol()
            s.info.status = status
            return s

        solve_jit_fn = solve_fn
    else:
        solve_jit_fn = solve_jit
    jax.block_until_ready(solve_jit_fn(qp, settings).x)  # compile + warm-up
    late = False
    if start_at > 0:
        # Concurrent-solo barrier: all D solo children start their timed
        # section at the same wall-clock instant, AFTER warmup/compile.
        late = time.time() > start_at
        while time.time() < start_at:
            time.sleep(0.005)
    dt = None
    for _ in range(REPS):
        t0 = time.perf_counter()
        sol = solve_jit_fn(qp, settings)
        jax.block_until_ready(sol.x)
        t = time.perf_counter() - t0
        dt = t if dt is None else min(dt, t)
    status = np.asarray(sol.info.status)
    solved = int(((status == 2) | (status == 3)).sum())
    print(json.dumps({
        "devices": n_devices, "batch": B_LOC * n_devices,
        "pinned_cores": sorted(os.sched_getaffinity(0)),
        "solved": solved, "time_s": dt, "late": late, "ablated": ablate,
        "solves_per_s": solved / dt,
    }))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--child", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--solo-core", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--start-at", type=float, default=0.0, help=argparse.SUPPRESS)
    p.add_argument("--ablate", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4])
    args = p.parse_args(argv)
    if args.child:
        child(args.child, args.solo_core, args.start_at, args.ablate)
        return 0

    cores = os.cpu_count() or 1
    devices = [d for d in args.devices if d <= cores]
    dropped = [d for d in args.devices if d > cores]
    if dropped:
        print(f"dropping D={dropped}: only {cores} physical cores — an "
              "oversubscribed point measures the scheduler, not SPMD "
              "overhead", file=sys.stderr)
    rows = []
    me = os.path.abspath(__file__)
    for d in devices:
        # A-side: the one-process SPMD mesh program over d pinned devices.
        out = subprocess.run(
            [sys.executable, me, "--child", str(d)],
            capture_output=True, text=True, timeout=1800)
        if out.returncode != 0:
            print(out.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"child D={d} failed")
        row = json.loads(out.stdout.strip().splitlines()[-1])

        # Ablated side: same one-process D-device program, collective
        # removed (local while predicate under shard_map).
        out_a = subprocess.run(
            [sys.executable, me, "--child", str(d), "--ablate"],
            capture_output=True, text=True, timeout=1800)
        if out_a.returncode != 0:
            print(out_a.stderr[-2000:], file=sys.stderr)
            raise SystemExit(f"ablated child D={d} failed")
        row_a = json.loads(out_a.stdout.strip().splitlines()[-1])
        row["ablated_time_s"] = row_a["time_s"]
        assert row_a["solved"] == row["solved"], (row_a, row)

        # B-side: d independent single-device processes, one core each,
        # started at the same wall-clock instant after warmup — true
        # zero-communication weak scaling at the process level.
        start_at = time.time() + 90.0
        procs = [subprocess.Popen(
            [sys.executable, me, "--child", "1", "--solo-core", str(c),
             "--start-at", str(start_at)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for c in range(d)]
        solo_times, late = [], False
        for pr in procs:
            so, se = pr.communicate(timeout=1800)
            if pr.returncode != 0:
                print(se[-2000:], file=sys.stderr)
                raise SystemExit(f"solo child failed at D={d}")
            srow = json.loads(so.strip().splitlines()[-1])
            solo_times.append(srow["time_s"])
            late |= srow["late"]
        row["solo_time_s"] = max(solo_times)
        row["solo_barrier_missed"] = late
        rows.append(row)
        print(f"D={d}: B={row['batch']} spmd {row['time_s']*1e3:8.1f} ms  "
              f"solo-concurrent {row['solo_time_s']*1e3:8.1f} ms  "
              f"cores {row['pinned_cores']}", file=sys.stderr)

    t1 = rows[0]["time_s"]
    s1 = rows[0]["solo_time_s"]
    for row in rows:
        # One pinned core per device and fixed per-device load, three views:
        #   spmd_wall_efficiency  — T(1)/T(D) of the sharded mesh program;
        #   solo_wall_efficiency  — T(1)/T(D) of D independent processes
        #                           (no mesh, no collectives: the shared-
        #                           memory-bandwidth floor of this host);
        #   spmd_overhead_ratio   — solo(D)/spmd(D): what running it as ONE
        #                           SPMD program costs (its collective + the
        #                           XLA CPU runtime's intra-process device
        #                           scheduling). <= 1.0; on real chips each
        #                           device owns its runtime, so only the
        #                           collective part transfers.
        row["spmd_wall_efficiency"] = t1 / row["time_s"]
        row["solo_wall_efficiency"] = s1 / row["solo_time_s"]
        row["spmd_overhead_ratio"] = row["solo_time_s"] / row["time_s"]
        # The decomposition: spmd = collective +
        # runtime-scheduling + solo-floor.
        #   collective_cost_ratio  = spmd(D)/ablated(D): cost of the one
        #     all-reduce (the while predicate) — the only part that
        #     transfers to real cards, where it rides NVLink.
        #   runtime_cost_ratio     = ablated(D)/solo(D): cost of XLA:CPU's
        #     intra-process multi-device scheduling — a CPU-client artifact
        #     with no analogue on real chips (one runtime per chip).
        row["collective_cost_ratio"] = row["time_s"] / row["ablated_time_s"]
        row["runtime_cost_ratio"] = row["ablated_time_s"] / row["solo_time_s"]
    result = {
        "benchmark": "weak_scaling_proxy",
        "platform": "cpu-virtual-devices-pinned",
        "physical_cores": cores,
        "lanes_per_device": B_LOC, "n": N,
        "note": ("Pinned-core three-way A/B at identical per-device load: "
                 "the SPMD mesh program, its collective-ABLATED twin (local "
                 "while predicate under shard_map — zero communication, "
                 "identical work), and D independent single-device "
                 "processes. collective_cost_ratio (spmd/ablated) is the "
                 "cost of the fleet solve's ONE collective and is the only "
                 "component that transfers to real chips; "
                 "runtime_cost_ratio (ablated/solo) is XLA:CPU's "
                 "intra-process device scheduling, which does not exist "
                 "there. The four-card measurement is chip_smoke.py --four."),
        "rows": rows,
    }
    path = os.path.join(os.path.dirname(__file__), "results",
                        "weak_scaling.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
