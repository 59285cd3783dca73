"""HBM / host memory accounting for run planning (BASELINE config 5).

The reference simply allocates everything statically (13 forcing fields at
96x48x730 ~= 175 MB, SURVEY §6); at 768x384 the same layout is ~11 GB and
must be budgeted against one device's memory or sharded along
latitude (parallel.multihost.make_global_forcing materializes only each
host's rows).  This module computes those budgets exactly from the
Numerics so tests and the CLI can assert a configuration fits before
compiling it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from ..config import Numerics

_B = 4  # float32 everywhere on the state/forcing path


@dataclass(frozen=True)
class MemoryReport:
    """All sizes in bytes; ``per_shard_*`` assume an even latitude split."""
    forcing: int            # 7x(t,y,x) + sw_solar (t,y) + 2 static (y,x)
    wind_splits: int        # uclim_m/p, vclim_m/p equivalents (built on the
    #                         fly per step here — 0 resident; the reference
    #                         keeps all four, src/greb.f90:109-120)
    corrections: int        # 3x(t,y,x)
    state: int              # 5x(y,x) per member
    fastcirc: int           # zd/zam/mer/wz coefficient fields (2 transported)
    monthly_out: int        # (12,5,y,x) accumulators per member
    total: int
    per_shard_total: int
    n_members: int
    n_shards: int
    detail: Dict[str, int] = field(default_factory=dict)
    # non-empty when the configuration cannot build at all (e.g. the
    # extension-mode CFL check rejects dt_crcl): the report still carries
    # the grid-independent budgets so planning callers can see them
    infeasible_reason: str = ""

    def fits(self, hbm_bytes: int, headroom: float = 0.75) -> bool:
        """Whether one shard's resident set fits in ``hbm_bytes`` with
        ``headroom`` (XLA scratch, fusion temporaries, output staging).
        On a live device, ``device.memory_stats()["bytes_limit"]`` is the
        memory JAX may allocate."""
        return self.per_shard_total <= hbm_bytes * headroom


def _fmt(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n} B"


def memory_report(num: Numerics, n_members: int = 1,
                  n_shards: int = 1) -> MemoryReport:
    """Exact resident-array accounting for a run shape.

    Everything time-indexed shards along latitude ('y'); members multiply
    only the per-member state/outputs (forcing and coefficients are shared
    across members on a chip, parallel/ensemble.py).  When ``n_shards > 1``
    the sharded fast path's dense composite block and advection level masks
    (fastcirc2.Fast2ShardConst.pcomp/amask) are included, with the slab
    geometry derived from the SAME collapse logic as
    ``fastcirc2.build_sharded`` (via ``fastcirc2.sharded_geometry``).
    """
    from ..grid import make_grid
    from ..ops import fastcirc2 as fc2

    t, y, x = num.nstep_yr, num.ydim, num.xdim
    cell = y * x * _B
    forcing = 7 * t * cell + t * y * _B + 2 * cell
    corrections = 3 * t * cell
    state = n_members * 5 * cell
    # fastcirc2.Fast2Const coefficient planes, derived from the fold itself
    fastcirc = fc2.N_COEF_PLANES * 2 * cell
    monthly = n_members * 12 * 5 * cell
    composites = 0
    amask = 0
    infeasible = ""
    if n_shards > 1 and y % n_shards == 0:
        # a pure planning function must keep reporting even when the grid
        # itself is infeasible (make_grid raises on CFL violations) —
        # advisor r3: report without the composite block instead of throwing
        try:
            geo = fc2.sharded_geometry(make_grid(x, y, num.dt_crcl),
                                       n_shards)
        except ValueError as e:
            geo = None
            infeasible = str(e)
        if geo is not None:
            if geo.comp_mode == "dense":
                composites = 2 * n_shards * max(geo.K, 1) * x * x * _B
            elif geo.comp_mode == "lowrank":
                # rank is data-dependent (SVD truncation); budget the worst
                composites = 2 * n_shards * max(geo.K, 1) * 2 * x * x * _B
            amask = max(geo.la_levels, 1) * y * _B
    total = forcing + corrections + state + fastcirc + monthly \
        + composites + amask
    # latitude sharding splits every y-axis array evenly (the composite
    # block shards along its per-shard-slot axis); scalars ignored
    per_shard = total // max(n_shards, 1)
    detail = {
        "one (t,y,x) field": t * cell,
        "forcing (7 clim + solar + 2 static)": forcing,
        "corrections (3x730-slot tables)": corrections,
        f"state (5 fields x {n_members} members)": state,
        "fastcirc coefficient fields": fastcirc,
        "monthly-mean outputs": monthly,
    }
    if composites:
        detail["sharded dense composites (pcomp)"] = composites
        detail["advection level masks (amask)"] = amask
    return MemoryReport(forcing=forcing, wind_splits=0,
                        corrections=corrections, state=state,
                        fastcirc=fastcirc, monthly_out=monthly, total=total,
                        per_shard_total=per_shard, n_members=n_members,
                        n_shards=n_shards, detail=detail,
                        infeasible_reason=infeasible)


def format_report(rep: MemoryReport) -> str:
    lines = [f"memory report ({rep.n_members} members, "
             f"{rep.n_shards} latitude shards):"]
    for k, v in rep.detail.items():
        lines.append(f"  {k:40s} {_fmt(v)}")
    lines.append(f"  {'TOTAL (global)':40s} {_fmt(rep.total)}")
    lines.append(f"  {'per shard':40s} {_fmt(rep.per_shard_total)}")
    if rep.infeasible_reason:
        lines.append(f"  NOTE: configuration cannot build "
                     f"(composite block omitted): {rep.infeasible_reason}")
    return "\n".join(lines)
