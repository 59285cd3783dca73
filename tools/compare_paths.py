"""Compare the three circulation paths of one scenario year at 384x192.

Runs, on one device, one scenario year with zero flux corrections and one
annual "month" (so the monthly output is the year's mean) through:

- ``fast``: the unsharded coefficient-folded circulation (the CLI's path);
- ``strict``: the masked strict stencils (the reference's loop structure);
- ``sharded``: the latitude-sharded fold of ``fastcirc2.build_sharded`` for
  ``--shards`` blocks, run on one device (``make_emulated_year_runners``),
  i.e. the program a ('y'=N) mesh runs, minus the cross-device exchange.

For each calendar length in ``--days`` and each pair it prints one JSON
line: the largest difference of each field's annual mean (ts, ta, to, q,
albedo), and the largest end-state ts difference with its latitude row.

Usage (on the machine with the GPU; the strict year takes minutes):
  python tools/compare_paths.py [--days 60,365] [--shards 4]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FIELDS = ("ts", "ta", "to", "q", "albedo")


def run_paths(days: int, shards: int) -> dict:
    """{path: (end-state ts, annual means (5, Y, X))} for one year."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from greb_tpu.config import GrebConfig, Numerics
    from greb_tpu.forcing import Corrections, forcing_from_arrays
    from greb_tpu.io.synthetic import make_synthetic_forcing
    from greb_tpu.model.driver import GREB
    from greb_tpu.ops import fastcirc2 as fc2
    from greb_tpu.parallel.sharded import make_emulated_year_runners
    from greb_tpu.regrid import regrid_forcing_arrays

    num = Numerics(xdim=384, ydim=192, ndays_yr=days, jday_mon=(days,),
                   time_flux=0, time_scnr=1)
    forcing = forcing_from_arrays(regrid_forcing_arrays(
        make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr), num))
    co2 = jnp.float32(680.0)
    corr0 = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    out = {}

    def keep(name, t0, state, monthly):
        jax.block_until_ready(monthly)
        out[name] = (np.asarray(state.ts), np.asarray(monthly)[0])
        print(f"# {days} days {name}: {time.perf_counter() - t0:.1f} s "
              "with compile", flush=True)

    for name, fast in (("fast", True), ("strict", False)):
        m = GREB(GrebConfig(numerics=num, fast_circulation=fast),
                 forcing=forcing, verbose=False)
        _, fcdata = m._fastcirc_split()
        t0 = time.perf_counter()
        s, mon, _ = m._year_scenario()(m.initial_state(), m.sfx, corr0, co2,
                                       m.md, fcdata)
        keep(name, t0, s, mon)
    splan, sconst = fc2.build_sharded(
        np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
        m.grid, m.st, kappa=float(m.params.kappa), n_shards=shards)
    _, scnr = make_emulated_year_runners(shards, m.st, num, m.exp,
                                         m.month_mat, fast_plan=splan)
    t0 = time.perf_counter()
    s, mon, _ = scnr(m.initial_state(), m.sfx, corr0, co2, m.md, sconst)
    keep("sharded", t0, s, mon)
    return out


def compare(a, b) -> dict:
    import numpy as np
    d_ts = np.abs(a[0].astype(np.float64) - b[0])
    d_mean = np.abs(a[1].astype(np.float64) - b[1])
    return {"end_ts_max": float(d_ts.max()),
            "end_ts_row": int(np.unravel_index(d_ts.argmax(),
                                               d_ts.shape)[0]),
            "annual_mean_max": {f: float(d_mean[i].max())
                                for i, f in enumerate(FIELDS)}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--days", default="60,365",
                    help="comma-separated calendar lengths (2 steps a day)")
    ap.add_argument("--shards", type=int, default=4,
                    help="latitude blocks of the sharded fold")
    args = ap.parse_args()

    from greb_tpu.runtime import (enable_compile_cache, gpu_name_and_power_limit,
                                  require_gpu)
    enable_compile_cache()
    dev = require_gpu()
    print(f"# {dev.device_kind}: {gpu_name_and_power_limit()}", flush=True)
    for days in (int(d) for d in args.days.split(",")):
        res = run_paths(days, args.shards)
        for a, b in (("fast", "strict"), ("sharded", "strict"),
                     ("fast", "sharded")):
            print(json.dumps({"pair": f"{a}-{b}", "steps": 2 * days,
                              "shards": args.shards,
                              **compare(res[a], res[b])}), flush=True)


if __name__ == "__main__":
    main()
