"""Chunked long-run driver (BASELINE config 5: 1000-yr integrations).

The reference cannot restart: state lives in Fortran module arrays and the
binary output keeps monthly means only (src/greb.f90:978-982), so a crash
loses the whole run.  Here a long scenario integrates in chunks of years;
after each chunk the prognostic state + the 730-slot correction tables +
a scalar cursor go to the ``Checkpointer`` (io/checkpoint.py), and a
fresh process resumes BIT-EXACTLY from the last checkpoint (the year
runner is deterministic and the checkpoint captures its full carry —
tests/test_config5.py proves equality against an uninterrupted run).

The chunk body is pluggable so the same loop drives the single-device
driver (``GREB.run_scenario``) and the shard_map runners over a device
mesh — checkpointing gathers addressable shards via np.asarray, resume
re-shards through ``parallel.sharded.shard_inputs``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..forcing import Corrections, ModelState
from ..io.checkpoint import Checkpointer, RunCursor

F32 = np.float32

# run_years(state, corr, co2_chunk: np.ndarray) -> (state, monthly | None)
YearRunner = Callable[[ModelState, Corrections, np.ndarray],
                      Tuple[ModelState, Optional[np.ndarray]]]


def run_long(total_years: int, state: ModelState, corr: Corrections,
             co2_series: np.ndarray, run_years: YearRunner,
             checkpointer: Optional[Checkpointer] = None,
             chunk_years: int = 50, resume: bool = True,
             on_chunk: Optional[Callable[[int, Optional[np.ndarray]], None]]
             = None) -> Tuple[ModelState, Corrections, int]:
    """Integrate ``total_years`` in chunks with periodic checkpoints.

    Returns ``(state, corr, start_year)`` where ``start_year`` is the year
    the loop actually started from (0, or the resumed cursor).
    """
    co2_series = np.asarray(co2_series, F32)
    assert len(co2_series) >= total_years, (len(co2_series), total_years)
    start = 0
    if resume and checkpointer is not None:
        last = checkpointer.latest_step()
        if last is not None:
            state, corr, cursor = checkpointer.restore(last)
            start = int(cursor.year_index)
    # resume-aware runners (e.g. driver_year_runner with an output file)
    # position their side effects from the actual start year — a resumed
    # process must neither lose nor duplicate the months written pre-crash
    on_resume = getattr(run_years, "on_resume", None)
    if on_resume is not None:
        on_resume(start)
    done = start
    while done < total_years:
        n = min(chunk_years, total_years - done)
        state, monthly = run_years(state, corr, co2_series[done:done + n])
        done += n
        if on_chunk is not None:
            on_chunk(done, monthly)
        if checkpointer is not None:
            # honor the configured every_years cadence (chunk boundaries
            # that don't land on it are skipped), but always persist the
            # final chunk so the run ends restartable
            cursor = RunCursor(phase="scenario", year_index=done,
                               co2=float(co2_series[done - 1]))
            if done == total_years or done % checkpointer.every == 0:
                checkpointer.save(done, state, corr, cursor)
    return state, corr, start


def driver_year_runner(model, output_path: Optional[str] = None,
                       collect_monthly: bool = False) -> YearRunner:
    """A ``run_years`` chunk body over ``GREB.run_scenario`` (single
    device).  Output records append across chunks AND across crash-resumes:
    the writer opens lazily, positioned at the record implied by the
    (possibly resumed) start year, so months written before a crash are
    kept and nothing is duplicated."""
    box = {"writer": None, "year": 0}
    months_per_year = len(model.num.jday_mon)

    def _writer():
        if output_path and box["writer"] is None:
            from ..io.binio import OutputWriter
            box["writer"] = OutputWriter(
                output_path, model.num.xdim, model.num.ydim,
                start_record=box["year"] * months_per_year
                * OutputWriter.NVAR)
        return box["writer"]

    def run_years(state, corr, co2_chunk):
        state, monthly, _ = model.run_scenario(
            corr, state=state, years=len(co2_chunk), co2_series=co2_chunk,
            collect_monthly=collect_monthly or bool(output_path))
        w = _writer()
        if w is not None:
            for m in monthly:
                w.write_months(m)
        box["year"] += len(co2_chunk)
        return state, monthly

    def on_resume(start_year: int) -> None:
        box["year"] = int(start_year)

    run_years.on_resume = on_resume
    return run_years


def sharded_year_runner(mesh, scnr_sh, sfx_s, md_s, fcconst=None,
                        shard_state: Optional[Callable] = None,
                        on_year: Optional[Callable[[np.ndarray], None]]
                        = None) -> YearRunner:
    """A chunk body over a sharded scenario-year runner
    (parallel.sharded.make_sharded_year_runners): one jitted call per year,
    state carried on-device.  ``shard_state`` (state -> sharded state) is
    applied once per chunk so a host-resident resume state lands back on the
    mesh with the right NamedShardings.

    ``on_year(monthly)`` streams each year's (months, 5, Y, X) array to the
    consumer as it lands on the host and the chunk returns ``monthly=None``
    — the host never holds more than one year (at 768x384 a 50-year chunk
    would otherwise stage ~3.4 GB; advisor r3).  Without it the full chunk
    stacks up for on_chunk consumers (fine at reference-size grids)."""
    import jax.numpy as jnp

    def run_years(state, corr, co2_chunk):
        if shard_state is not None:
            state = shard_state(state)
        months: List[np.ndarray] = []
        for co2 in np.asarray(co2_chunk, F32):
            args = (state, sfx_s, corr, jnp.float32(co2), md_s)
            if fcconst is not None:
                args += (fcconst,)
            state, monthly, _ = scnr_sh(*args)
            if on_year is not None:
                on_year(np.asarray(monthly))
            else:
                months.append(np.asarray(monthly))
        # (years, months, 5, Y, X): every year of the chunk, so on_chunk
        # consumers (output writers) see the full chunk, not just its tail
        return state, (np.stack(months) if months else None)

    return run_years
