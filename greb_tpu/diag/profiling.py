"""Tracing / profiling / runtime-health subsystem.

The reference has no observability beyond an unused gprof flag and three
timer variables (Makefile:10, src/greb.f90:126; SURVEY §5).  Here:

- ``phase_timer``   : wall-clock per-phase timing with derived throughput
                      (sim-yr/s, grid-point-steps/s).
- ``trace``         : context manager around ``jax.profiler`` producing a
                      TensorBoard-loadable device trace.
- ``check_finite``  : runtime NaN/Inf detection over a pytree (the
                      equivalent of the reference debug build's
                      ``-ffpe-trap``), raising with the offending leaf names.
- ``RunMetrics``    : accumulates per-year scalars (global-mean Ts, CO2,
                      wall time) and serializes to JSONL for dashboards.
"""
from __future__ import annotations

import contextlib
import json
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import numpy as np


@dataclass
class PhaseStats:
    name: str
    wall_s: float
    sim_years: int = 0
    grid_points: int = 0
    steps_per_year: int = 0

    @property
    def sim_yr_per_s(self) -> float:
        return self.sim_years / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def point_steps_per_s(self) -> float:
        return (self.grid_points * self.steps_per_year * self.sim_years
                / self.wall_s) if self.wall_s > 0 else 0.0


class phase_timer(contextlib.AbstractContextManager):
    """with phase_timer("scenario", sim_years=50, num=num) as t: ...
    -> t.stats has throughput numbers after the block."""

    def __init__(self, name: str, sim_years: int = 0, num=None,
                 verbose: bool = False):
        self.name = name
        self.sim_years = sim_years
        self.num = num
        self.verbose = verbose
        self.stats: Optional[PhaseStats] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        gp = (self.num.xdim * self.num.ydim) if self.num else 0
        spy = self.num.nstep_yr if self.num else 0
        self.stats = PhaseStats(self.name, wall, self.sim_years, gp, spy)
        if self.verbose:
            s = self.stats
            print(f"% [{s.name}] {s.wall_s:.2f}s"
                  + (f" | {s.sim_yr_per_s:.2f} sim-yr/s"
                     f" | {s.point_steps_per_s:.3e} point-steps/s"
                     if s.sim_years else ""))
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace via jax.profiler (view with TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_trace_summary(log_dir: str, device: str = "/device:GPU:0"
                         ) -> Dict:
    """Reduce the newest ``jax.profiler`` trace under ``log_dir`` to counts
    for one device (``summarize_device_lines``) and, under "host", the
    host threads' launch and wait calls (``summarize_host_lines``)."""
    import glob
    import os
    paths = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])

    dev, host = {}, {}
    for plane in data.planes:
        for line in plane.lines:
            events = [(e.name, e.start_ns, e.end_ns) for e in line.events]
            if plane.name == device:
                dev[line.name] = events
            elif plane.name.startswith("/host"):
                host[f"{plane.name}/{line.name}"] = events
    out = summarize_device_lines(dev)
    out["host"] = summarize_host_lines(host)
    return out


def copy_kind(event_name: str) -> Optional[str]:
    """"h2d", "d2h", "d2d" or "p2p" for a copy the GPU trace records
    (event names "MemcpyH2D", "MemcpyDtoH", ...), "memset" for a memset,
    None for a kernel (even one named like "memcpy32_post")."""
    m = re.match(r"Memcpy([HDP])(?:2|to)([HDP])", event_name)
    if m:
        return f"{m.group(1)}2{m.group(2)}".lower()
    return "memset" if event_name.startswith("Memset") else None


def summarize_device_lines(lines: Dict[str, List]) -> Dict:
    """Counts from one device's trace lines ``{line name: [(event name,
    start_ns, end_ns), ...]}``: events per line; on the stream lines (names
    starting "Stream"), kernels, copies by ``copy_kind``, and every distinct
    event name that reads like a copy or memset with its kind and count;
    their busy time (union of intervals); and the window from the first
    start to the last end."""
    out = {"lines": {name: len(ev) for name, ev in lines.items()},
           "kernels": 0, "copies": {}, "copy_names": {},
           "busy_ns": 0, "window_ns": 0}
    spans = []
    for name, events in lines.items():
        if not name.startswith("Stream"):
            continue
        for ev_name, start, end in events:
            kind = copy_kind(ev_name)
            if kind is None:
                out["kernels"] += 1
            else:
                out["copies"][kind] = out["copies"].get(kind, 0) + 1
            if kind is not None or re.search("memcpy|memset", ev_name,
                                             re.IGNORECASE):
                entry = out["copy_names"].setdefault(
                    ev_name, {"kind": kind or "kernel", "count": 0})
                entry["count"] += 1
            spans.append((start, end))
    if spans:
        spans.sort()
        busy, (s0, e0) = 0, spans[0]
        for s, e in spans[1:]:
            if s > e0:
                busy += e0 - s0
                s0, e0 = s, e
            else:
                e0 = max(e0, e)
        out["busy_ns"] = busy + (e0 - s0)
        out["window_ns"] = max(e for _, e in spans) - spans[0][0]
    return out


# host-side calls that show how the host drives the device: a launch per
# loop iteration puts the host in the loop; a synchronisation or a
# device-to-host copy per iteration makes it wait there
HOST_CALLS = {
    "graph_launch": r"^cuGraphLaunch",
    "kernel_launch": r"^cuLaunchKernel",
    "while_thunk": r"^while(\.\d+)?$",
    "sync": r"Synchronize|BlockHostUntilDone",
    "d2h": r"^cuMemcpyDtoH|^MemcpyD2H|^MemcpyDtoH",
}


def summarize_host_lines(lines: Dict[str, List]) -> Dict:
    """Counts of the ``HOST_CALLS`` classes over host trace lines (same
    form as for ``summarize_device_lines``), with each matching event name
    and its count under "names"."""
    out = {k: 0 for k in HOST_CALLS}
    out["names"] = {}
    for events in lines.values():
        for ev_name, _, _ in events:
            for k, pat in HOST_CALLS.items():
                if re.search(pat, ev_name):
                    out[k] += 1
                    out["names"][ev_name] = out["names"].get(ev_name, 0) + 1
    return out


def check_finite(tree, name: str = "state") -> None:
    """Raise FloatingPointError naming every non-finite leaf.  The runtime
    analog of the reference debug build's FPE traps (Makefile:10)."""
    bad: List[str] = []
    leaves, treedef = jax.tree.flatten_with_path(tree)
    for path, leaf in leaves:
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            n = int((~np.isfinite(arr)).sum())
            bad.append(f"{name}{jax.tree_util.keystr(path)}: {n} non-finite")
    if bad:
        raise FloatingPointError("; ".join(bad))


@dataclass
class RunMetrics:
    """Per-year scalar metrics, serializable to JSONL."""
    records: List[Dict] = field(default_factory=list)

    def log_year(self, year: int, co2: float, global_mean_ts: float,
                 wall_s: float, **extra) -> None:
        rec = dict(year=year, co2=float(co2),
                   global_mean_ts=float(global_mean_ts),
                   wall_s=float(wall_s), **extra)
        self.records.append(rec)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    @classmethod
    def load(cls, path: str) -> "RunMetrics":
        with open(path) as f:
            return cls(records=[json.loads(line) for line in f if line.strip()])
