"""Tracing/profiling helpers (SURVEY.md §5 tracing plan).

The reference profiles with BenchmarkTools timing macros
(`RunBenchmarks.jl:98-104`); the equivalents here are wall-clock timing
around jitted calls that end in ``jax.block_until_ready``
(bench/harness.py), and XLA profiler traces reduced to device time per
``jax.named_scope`` of the solvers (:func:`scope_device_times`).

The solvers name three scopes: ``factor`` (normal-matrix build and
Cholesky/inverse — models/kkt.py, models/proxqp.py), ``chunk`` (the
``check_interval`` iterations between checks) and ``check`` (residuals,
termination and certificates).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import re
import time

#: The solvers' named scopes, in the order reports list them.
SOLVER_SCOPES = ("factor", "chunk", "check")

_HLO_OP_NAME = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?\bop_name="([^"]*)"', re.M)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XLA profiler trace viewable in TensorBoard/Perfetto.

    >>> with trace("chiprun_out/trace"):
    ...     sol = qps.solve_jit(qp, settings)
    ...     jax.block_until_ready(sol.x)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Accumulating wall-clock timer.

    Call ``jax.block_until_ready`` on the result *inside* the block,
    otherwise the measurement ends before the (async-dispatched) device
    work does:

    >>> t = Timer()
    >>> with t.measure():
    ...     sol = jax.block_until_ready(qps.solve_jit(qp, settings))
    """

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def hlo_op_names(hlo_text: str) -> dict:
    """Instruction name -> ``op_name`` metadata, from compiled HLO text
    (``jitted.lower(...).compile().as_text()``)."""
    return dict(_HLO_OP_NAME.findall(hlo_text))


def scope_of(op_name: str, scopes=SOLVER_SCOPES) -> str:
    """Innermost of ``scopes`` on an op's name path, else ``"other"``."""
    for part in reversed(op_name.split("/")):
        if part in scopes:
            return part
    return "other"


def _newest_xplane(trace_dir: str) -> str:
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return files[-1]


def scope_device_times(trace_dir: str, hlo_text: str,
                       plane_prefix: str = "/device:GPU",
                       scopes=SOLVER_SCOPES) -> dict:
    """Sum a trace's op durations (seconds) per solver scope.

    Reads the newest ``*.xplane.pb`` under ``trace_dir``. Every event with
    an ``hlo_op`` stat on a plane whose name starts with ``plane_prefix``
    is one executed kernel or copy. It is looked up in ``hlo_text`` (the
    traced program's compiled HLO) and charged to :func:`scope_of` its
    ``op_name``:

    * by its ``hlo_op`` instruction name;
    * inside a GPU command buffer (CUDA graph) every kernel reports
      ``hlo_op == "command_buffer"``, so by the event's own name, which is
      the fusion's instruction name with ``.`` written as ``_``;
    * a library kernel inside a command buffer (a cuBLAS GEMM) has no
      instruction name: it is charged to the scope that holds most of the
      resolved time of its CUDA graph.

    Anything else (other programs, unresolved kernels) is ``"other"``.
    Returns ``{scope: seconds, ..., "other": seconds, "total": seconds}``;
    "total" is the plain sum, so overlapping streams can count twice.
    """
    from jax.profiler import ProfileData

    names = hlo_op_names(hlo_text)
    names.update({k.replace(".", "_"): v for k, v in list(names.items())})
    events = []           # (scope or None, cuda graph id or None, seconds)
    graph_time = collections.defaultdict(collections.Counter)
    for plane in ProfileData.from_file(_newest_xplane(trace_dir)).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                op_name = names.get(op) or names.get(ev.name)
                scope = None if op_name is None else scope_of(op_name, scopes)
                graph = stats.get("cuda_graph_id")
                sec = ev.duration_ns * 1e-9
                events.append((scope, graph, sec))
                if scope is not None and graph is not None:
                    graph_time[graph][scope] += sec
    out = collections.Counter({s: 0.0 for s in (*scopes, "other")})
    for scope, graph, sec in events:
        if scope is None and graph_time.get(graph):
            scope = graph_time[graph].most_common(1)[0][0]
        out[scope or "other"] += sec
    out["total"] = sum(out.values())
    return dict(out)
