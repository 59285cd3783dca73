"""Time and trace what XLA makes of the plain main path on the GPU.

For 96x48 (full 730-step calendar) and 384x192 (a 30-day calendar; the
time per step does not depend on the calendar length) this measures, with
the coefficient-folded circulation of the CLI:

- the time per simulated 12-hour step of a warm scenario year;
- from one ``jax.profiler`` trace of a jitted 24-substep circulation call
  (a ``fori_loop`` of 24 iterations): device kernels per substep, every
  distinct copy or memset event name with its kind and count, and the
  host's launch and wait calls per iteration;
- the same from one trace of a short scenario year, per step, with the
  device's busy share of the traced window.

Whether each loop iteration waits on the host is read from those names: a
device-to-host copy or a host synchronisation per iteration means it
waits; a graph or kernel launch per iteration means the host issues every
iteration without waiting for it.

With ``--strict`` it also times the strict-stencil year at 96x48.

Usage (on the machine with the GPU):
  python tools/trace_xla.py [--strict]
Prints one JSON line; traces go to chiprun_out/trace_xla/.
"""
import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _model(xdim, ydim, ndays, fast=True):
    from greb_tpu.config import GrebConfig, Numerics
    from greb_tpu.forcing import forcing_from_arrays
    from greb_tpu.io.synthetic import make_synthetic_forcing
    from greb_tpu.model.driver import GREB
    from greb_tpu.regrid import regrid_forcing_arrays

    jday = ((31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31) if ndays == 365
            else (ndays,))
    num = Numerics(xdim=xdim, ydim=ydim, ndays_yr=ndays, jday_mon=jday,
                   time_flux=1, time_scnr=1)
    arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
    if (xdim, ydim) != (96, 48):
        arrs = regrid_forcing_arrays(arrs, num)
    return GREB(GrebConfig(numerics=num, fast_circulation=fast),
                forcing=forcing_from_arrays(arrs), verbose=False)


def _year_runner(m):
    """(state, corr, run) for warm scenario years of ``m``."""
    import jax
    import jax.numpy as jnp
    from greb_tpu.forcing import Corrections

    corr = Corrections.zeros(m.num.nstep_yr, m.num.ydim, m.num.xdim)
    runner = m._year_scenario(with_outputs=True)
    _, fcdata = m._fastcirc_split()
    co2 = jnp.float32(680.0)

    def run(state):
        out = runner(state, m.sfx, corr, co2, m.md, fcdata)
        jax.block_until_ready(out)
        return out[0]
    return m.initial_state(), run


def time_year(m) -> dict:
    state, run = _year_runner(m)
    t0 = time.perf_counter()
    state = run(state)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(state)
    year_s = time.perf_counter() - t0
    return {"compile_and_first_year_s": compile_s, "year_s": year_s,
            "us_per_step": year_s / m.num.nstep_yr * 1e6,
            "steps": m.num.nstep_yr}


def per_iteration(s: dict, n: int) -> dict:
    """A trace summary (``device_trace_summary``) per loop iteration, and
    the host-wait verdict drawn from its event names."""
    host = s["host"]
    d2h = max(s["copies"].get("d2h", 0), host["d2h"])
    return {
        "iterations": n, "kernels": s["kernels"] / n,
        "copies": {k: v / n for k, v in s["copies"].items()},
        "graph_launches": host["graph_launch"] / n,
        "kernel_launches": host["kernel_launch"] / n,
        "host_syncs": host["sync"] / n, "d2h": d2h / n,
        "host_waits_each_iteration": d2h + host["sync"] >= n,
        "host_launches_each_iteration":
            host["graph_launch"] + host["kernel_launch"] >= n,
        "copy_names": s["copy_names"], "host_names": host["names"],
        "lines": s["lines"]}


def trace_year(m, log_dir) -> dict:
    from greb_tpu.diag.profiling import device_trace_summary, trace
    state, run = _year_runner(m)
    state = run(state)                       # compile outside the trace
    with trace(log_dir):
        run(state)
    s = device_trace_summary(log_dir)
    r = per_iteration(s, m.num.nstep_yr)     # per 12-h step
    r["busy_share"] = (s["busy_ns"] / s["window_ns"] if s["window_ns"]
                       else None)
    return r


def trace_circulation(m, log_dir) -> dict:
    """Per substep, from one jitted nsub-substep circulation call."""
    import jax
    import jax.numpy as jnp
    from greb_tpu.diag.profiling import device_trace_summary, trace
    from greb_tpu.ops import fastcirc2 as fc2

    plan, (const,) = m._fastcirc_split()
    nsub = m.num.nsub_crcl
    s0 = m.initial_state()

    @jax.jit
    def circ(x, u, v, const):
        cf = fc2.step_coeffs(u, v, const, plan)
        return fc2.circulation(x, cf, const, plan, nsub)

    x = jnp.stack([s0.ta, s0.q])
    args = (x, m.sfx.u[0], m.sfx.v[0], const)
    jax.block_until_ready(circ(*args))
    with trace(log_dir):
        jax.block_until_ready(circ(*args))
    return per_iteration(device_trace_summary(log_dir), nsub)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true",
                    help="also time the strict-stencil year at 96x48")
    args = ap.parse_args()

    from greb_tpu.runtime import (enable_compile_cache, gpu_name_and_power_limit,
                                  require_gpu)
    enable_compile_cache()
    dev = require_gpu()
    card = gpu_name_and_power_limit()
    out_dir = os.path.join(ROOT, "chiprun_out", "trace_xla")
    shutil.rmtree(out_dir, ignore_errors=True)
    res = {"device": dev.device_kind, "card": card}
    for (x, y, nd_time, nd_trace) in ((96, 48, 365, 10), (384, 192, 30, 30)):
        key = f"{x}x{y}"
        t0 = time.perf_counter()
        m = _model(x, y, nd_time)
        r = {"build_s": time.perf_counter() - t0, "timing": time_year(m)}
        r["circulation_trace"] = trace_circulation(
            m, os.path.join(out_dir, key + "_circ"))
        mt = m if nd_trace == nd_time else _model(x, y, nd_trace)
        r["year_trace"] = trace_year(mt, os.path.join(out_dir, key + "_year"))
        res[key] = r
        print(f"# {key}: {json.dumps(r)}", flush=True)
    if args.strict:
        res["96x48_strict"] = time_year(_model(96, 48, 365, fast=False))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
