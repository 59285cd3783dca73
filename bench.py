"""Headline benchmark: scenario throughput in simulated years per second.

Reference baseline: ~1 simulated year/second on a laptop (gfortran -O3;
reference README.md:3, BASELINE.md).  Default workload shape: 96x48 grid,
730 steps/yr, 24 circulation substeps/step, monthly means of 5 variables.

Runs on an NVIDIA GPU only: any other device is refused.  Prints ONE JSON
line:
  {"metric": "sim_years_per_sec", "value": N, "unit": "sim-yr/s",
   "vs_baseline": N, "configs": {...}, "labels": {...}, "device": {...}}

Extra context (per-config numbers) goes to stderr.  Configs are selected
with GREB_BENCH_GRID / GREB_BENCH_GRID2 (WxH or "off") and GREB_BENCH_ENS
(members, 0 = off).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _steady_rate(step_year, state, years: int) -> float:
    """step_year(state) -> state; returns steady-state years/sec."""
    import jax
    s = step_year(state)                      # warm: compile + first exec
    jax.block_until_ready(jax.tree.leaves(s)[0])
    t0 = time.perf_counter()
    for _ in range(years):
        s = step_year(s)
    jax.block_until_ready(jax.tree.leaves(s)[0])
    return years / (time.perf_counter() - t0)


def main() -> None:
    import jax
    import jax.numpy as jnp
    from greb_tpu.config import GrebConfig, Numerics
    from greb_tpu.model.driver import GREB
    from greb_tpu.runtime import (enable_compile_cache,
                                  gpu_name_and_power_limit, require_gpu)

    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        sys.exit(2)
    enable_compile_cache()
    bench_years = int(os.environ.get("GREB_BENCH_YEARS", "20"))

    num = Numerics(time_flux=1, time_scnr=bench_years)
    co2 = jnp.float32(680.0)

    results = {}

    # --- XLA path (strict stencils, unrolled substeps) ---------------------
    m = GREB(GrebConfig(numerics=num, unroll_circulation=True),
             verbose=False)
    state_fc, corr = m.flux_correction()
    runner = m._year_scenario(with_outputs=True)
    state = m.initial_state().replace(cap_surf=state_fc.cap_surf)

    def run_xla(s):
        s2, monthly, mf = runner(s, m.sfx, corr, co2, m.md)
        return s2

    rate = _steady_rate(run_xla, state, bench_years)
    results["xla"] = rate
    print(f"# xla: {rate:.2f} sim-yr/s", file=sys.stderr)

    # --- refined grids (configs 4-5 of BASELINE.json) -----------------------
    # measured by default; override/disable via GREB_BENCH_GRID=WxH|off and
    # GREB_BENCH_GRID2=WxH|off (the config-5 768x384 grid, VERDICT r4 #1)
    labels = {}
    grid_specs = []
    grid_env = os.environ.get("GREB_BENCH_GRID", "384x192")
    if grid_env and grid_env != "off":
        grid_specs.append((grid_env, 1800, max(2, bench_years // 5)))
    grid2_env = os.environ.get("GREB_BENCH_GRID2", "768x384")
    if grid2_env and grid2_env != "off":
        grid_specs.append((grid2_env, 450, 1))
    for genv, dtc, gny in grid_specs:
        gx, gy = (int(s) for s in genv.lower().split("x"))
        from greb_tpu.forcing import forcing_from_arrays
        from greb_tpu.io.synthetic import make_synthetic_forcing
        from greb_tpu.regrid import regrid_forcing_arrays
        gnum = Numerics(xdim=gx, ydim=gy, dt_crcl=dtc, time_flux=1,
                        time_scnr=3)
        # full-calendar refined-grid regrids cost minutes of host CPU on
        # small hosts — cache them (deterministic: synthetic seed +
        # bilinear weights); shared with tools/run_config5.py at 768x384
        import tempfile
        import numpy as _np
        tmp = tempfile.gettempdir()
        cache = (os.environ.get("GREB_C5_FORCING_CACHE",
                                os.path.join(tmp, "greb_f768_cache.npz"))
                 if (gx, gy) == (768, 384)
                 else os.path.join(tmp, f"greb_forcing_{gx}x{gy}.npz"))
        if os.path.exists(cache):
            arrs = dict(_np.load(cache))
        else:
            arrs = make_synthetic_forcing(96, 48, gnum.nstep_yr,
                                          gnum.ndays_yr)
            arrs = regrid_forcing_arrays(arrs, gnum)
            _np.savez(cache + ".tmp.npz", **arrs)
            os.replace(cache + ".tmp.npz", cache)
        gforc = forcing_from_arrays(arrs)
        gm = GREB(GrebConfig(numerics=gnum, fast_circulation=True),
                  forcing=gforc, verbose=False)
        sfc, corr_g = gm.flux_correction()
        gpath = "xla-fast"
        _, fcdata = gm._fastcirc_split()
        jr = gm._year_scenario(with_outputs=True)

        def run_g(s):
            return jr(s, gm.sfx, corr_g, co2, gm.md, fcdata)[0]

        rate = _steady_rate(run_g, sfc, gny)
        pts = gx * gy * gnum.nstep_yr * rate
        print(f"# grid[{gx}x{gy}]: {rate:.3g} sim-yr/s "
              f"({pts / 1e6:.0f} M point-steps/s, {rate * 86400:.0f} "
              f"sim-yr/day, {gpath}, dt_crcl={dtc})", file=sys.stderr)
        results[f"grid[{genv}]"] = rate
        labels[f"grid[{genv}]"] = {"path": gpath, "dt_crcl": dtc,
                                   "sim_yr_per_day": round(rate * 86400, 1)}
        # release this grid's device arrays (768x384 holds ~10 GB:
        # forcing + correction tables) before the ensemble lane
        import gc
        del gm, sfc, corr_g, arrs, gforc
        gc.collect()

    # --- ensemble aggregate (config 3 of BASELINE.json) ---------------------
    # batched matmul runner: member axis inside the arrays, zonal applies as
    # (M, X) @ (X, X) batched matmuls (fastcirc2.mxu_circulation);
    # GREB_BENCH_ENS=0 disables
    n_ens = int(os.environ.get("GREB_BENCH_ENS", "256"))
    if n_ens > 0:
        import numpy as _np
        from greb_tpu.ops import fastcirc2 as fc2
        from greb_tpu.parallel import ensemble as ens
        m = GREB(GrebConfig(numerics=num, fast_circulation=True),
                 verbose=False)
        perturb = {"ct_sens": _np.float32(22.5)
                   * (1.0 + 0.02 * _np.linspace(-1, 1, n_ens, dtype=_np.float32))}
        pb = ens.perturbed_params(m.params, perturb)
        md_b = ens.batched_model_data(pb, m.forcing, m.sf)
        state_b = ens.ensemble_initial_state(
            pb, m.forcing, ens.ensemble_data(pb, m.forcing, m.sf))
        plan, (const,) = m._fastcirc_split()
        # "stacked" = both zonal applies in ONE matmul; precision "highest"
        fcdata = (const, fc2.build_mxu(const, plan, mode="stacked"))
        flux_b, scnr_b = ens.make_batched_ensemble_runners(
            m.st, m.num, m.exp, m.month_mat, fast_plan=plan)
        state_b, corr_b = flux_b(state_b, m.sfx, co2, md_b, fcdata)

        def run_ens(s):
            s2, _, _ = scnr_b(s, m.sfx, corr_b, co2, md_b, fcdata)
            return s2

        years = max(3, bench_years // 4)
        rate = _steady_rate(run_ens, state_b, years) * n_ens
        results[f"ensemble[{n_ens}]"] = rate
        # self-describing artifact (VERDICT r4 #8): the aggregate number is
        # mode- and precision-dependent
        labels[f"ensemble[{n_ens}]"] = {"mxu_mode": "stacked",
                                        "precision": "highest (float32)",
                                        "spinup": "per-member"}
        print(f"# ensemble[{n_ens}]: {rate:.1f} aggregate sim-yr/s "
              f"({rate / n_ens:.2f} per member, stacked matmuls, highest)",
              file=sys.stderr)

    if not results:
        print("# no benchmark mode ran", file=sys.stderr)
        sys.exit(1)

    # headline = best SINGLE-RUN rate (ensemble aggregate is a different
    # metric, reported on stderr only)
    single = {k: v for k, v in results.items()
              if not (k.startswith("ensemble") or k.startswith("grid["))}
    best_mode, best = max(single.items(), key=lambda kv: kv[1])
    print(f"# best={best_mode} on {dev.platform}:{dev.device_kind}; "
          f"workload: {bench_years}-yr 2xCO2 scenario, 96x48, 730 steps/yr",
          file=sys.stderr)

    out = {
        "metric": "sim_years_per_sec",
        "value": round(best, 3),
        "unit": "sim-yr/s",
        "vs_baseline": round(best / 1.0, 3),
        # every measured config rides in the driver artifact (VERDICT r2 #6):
        # single-run modes in sim-yr/s, ensemble[M] in aggregate member-yr/s,
        # grid[WxH] in sim-yr/s at that grid
        "configs": {k: round(v, 3) for k, v in results.items()},
        # per-config mode/precision/path labels (VERDICT r4 #8)
        "labels": labels,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()),
                   "nvidia_smi": gpu_name_and_power_limit()},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
