"""BASELINE config 5 as ONE workload (VERDICT r3 task 2).

768x384 refined grid, FULL 730-step calendar, dt_crcl=450 (the extension
budget; grid.py), spin-up + >= 50 scenario years through the folded
circulation, with the monthly output stream ON, periodic checkpoints, and
a KILLED-AND-RESUMED variant in a fresh process proven bit-exact against
the uninterrupted run (state AND output bytes).  The reference dies at
this grid: its integer sub-step dt_crcl/dd truncates to zero
(src/greb.f90:652-653).

One device; the grid is latitude-shardable (parallel/sharded.py,
tests/test_config5.py) but one device holds the whole problem (~10 GiB
incl. forcing; diag/memory.py).  The parent process stays off JAX and runs
the phases one at a time, so only one process holds the device.

Usage:
  python tools/run_config5.py             # all phases, prints JSON
  python tools/run_config5.py full DIR    # uninterrupted YEARS
  python tools/run_config5.py part DIR N  # run to year N, then 'crash'
  python tools/run_config5.py resume DIR  # fresh process resumes
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

YEARS = int(os.environ.get("GREB_C5_YEARS", "50"))
CHUNK = int(os.environ.get("GREB_C5_CHUNK", "10"))
CKPT_EVERY = int(os.environ.get("GREB_C5_CKPT", "10"))
FLUX_YEARS = int(os.environ.get("GREB_C5_FLUX", "3"))


def _model():
    import numpy as np

    from greb_tpu.config import GrebConfig, Numerics
    from greb_tpu.forcing import forcing_from_arrays
    from greb_tpu.io.synthetic import make_synthetic_forcing
    from greb_tpu.model.driver import GREB
    from greb_tpu.regrid import regrid_forcing_arrays

    num = Numerics(xdim=768, ydim=384, dt_crcl=450, time_flux=FLUX_YEARS,
                   time_scnr=YEARS)
    # regridding the full-calendar climatology to 768x384 costs ~12 min of
    # host CPU on this box; cache it across the three phases (the arrays
    # are deterministic: synthetic seed + bilinear weights)
    cache = os.environ.get("GREB_C5_FORCING_CACHE", os.path.join(
        tempfile.gettempdir(), "greb_f768_cache.npz"))
    if cache and os.path.exists(cache):
        arrs = dict(np.load(cache))
    else:
        arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
        arrs = regrid_forcing_arrays(arrs, num)
        if cache:
            np.savez(cache + ".tmp.npz", **arrs)
            os.replace(cache + ".tmp.npz", cache)
    forcing = forcing_from_arrays(arrs)
    return GREB(GrebConfig(numerics=num, fast_circulation=True),
                forcing=forcing, verbose=False)


def _run(workdir: str, stop_year, resume: bool) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from greb_tpu.forcing import Corrections
    from greb_tpu.io.checkpoint import Checkpointer
    from greb_tpu.model import longrun
    from greb_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    t_build0 = time.perf_counter()
    m = _model()
    build_s = time.perf_counter() - t_build0
    ck = Checkpointer(os.path.join(workdir, "ck"), every_years=CKPT_EVERY)
    out_path = os.path.join(workdir, "scenario")
    runner = longrun.driver_year_runner(m, output_path=out_path)
    co2 = np.full(YEARS, 680.0, np.float32)

    if resume:
        state = jax.tree.map(jnp.zeros_like, m.initial_state())
        corr = Corrections.zeros(m.num.nstep_yr, m.num.ydim, m.num.xdim)
        t_fc = 0.0
    else:
        t0 = time.perf_counter()
        state, corr = m.flux_correction()
        t_fc = time.perf_counter() - t0

    target = stop_year if stop_year else YEARS
    t0 = time.perf_counter()
    state, corr, start = longrun.run_long(
        target, state, corr, co2, runner, checkpointer=ck,
        chunk_years=CHUNK)
    wall = time.perf_counter() - t0
    ts = np.asarray(state.ts)
    rate = (target - start) / wall if wall else 0.0
    res = {
        "years_run": target - start, "start_year": start,
        "wall_s": round(wall, 1), "sim_yr_per_s": round(rate, 4),
        "sim_yr_per_day": round(rate * 86400.0, 0),
        "build_s": round(build_s, 1), "flux_corr_s": round(t_fc, 1),
        "ts_mean_K": float(ts.mean()), "ts_min": float(ts.min()),
        "ts_max": float(ts.max()),
        "state_sha": hashlib.sha256(
            b"".join(np.asarray(getattr(state, f)).tobytes()
                     for f in ("ts", "ta", "to", "q", "cap_surf"))
        ).hexdigest()[:16],
    }
    assert np.isfinite(ts).all() and 150.0 < ts.min() and ts.max() < 400.0, \
        "non-physical state"
    if target == YEARS:
        h = hashlib.sha256()
        with open(out_path, "rb") as f:
            while True:
                b = f.read(1 << 22)
                if not b:
                    break
                h.update(b)
        res["output_bytes"] = os.path.getsize(out_path)
        res["output_sha"] = h.hexdigest()[:16]
    return res


def main() -> None:
    if len(sys.argv) > 1:
        phase, workdir = sys.argv[1], sys.argv[2]
        os.makedirs(workdir, exist_ok=True)
        if phase == "full":
            out = _run(workdir, None, resume=False)
        elif phase == "part":
            out = _run(workdir, int(sys.argv[3]), resume=False)
        elif phase == "resume":
            out = _run(workdir, None, resume=True)
        else:
            raise SystemExit(f"unknown phase {phase}")
        print("PHASE_RESULT " + json.dumps(out))
        return

    base = os.environ.get("GREB_C5_DIR",
                          os.path.join(tempfile.gettempdir(), "greb_config5"))
    # a stale workdir makes run_long silently RESUME from old checkpoints
    # and measure a no-op — start clean
    import shutil
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base, exist_ok=True)

    def phase(*args, timeout=4200):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                           capture_output=True, text=True, timeout=timeout)
        for ln in p.stdout.splitlines():
            if ln.startswith("PHASE_RESULT "):
                return json.loads(ln[len("PHASE_RESULT "):])
        sys.stderr.write(p.stdout[-2000:] + p.stderr[-4000:])
        raise SystemExit(f"phase {args} failed rc={p.returncode}")

    d_full = os.path.join(base, "full")
    d_res = os.path.join(base, "resumed")
    print(f"# config 5: uninterrupted {YEARS}-yr 768x384 run ...",
          file=sys.stderr)
    r_full = phase("full", d_full)
    print(f"#   {r_full['sim_yr_per_s']:.3f} sim-yr/s "
          f"({r_full['sim_yr_per_day']:.0f} sim-yr/day), "
          f"Ts mean {r_full['ts_mean_K']:.2f} K", file=sys.stderr)
    half = (YEARS // 2 // CKPT_EVERY) * CKPT_EVERY
    print(f"# interrupted run to year {half}, then killed ...",
          file=sys.stderr)
    phase("part", d_res, str(half))
    print(f"# fresh-process resume to {YEARS} ...", file=sys.stderr)
    r_res = phase("resume", d_res)
    ok_state = r_res["state_sha"] == r_full["state_sha"]
    ok_out = r_res.get("output_sha") == r_full.get("output_sha")
    summary = {
        "config": 5, "grid": "768x384", "calendar": "730 steps/yr",
        "dt_crcl": 450, "years": YEARS,
        "sim_yr_per_s": r_full["sim_yr_per_s"],
        "sim_yr_per_day": r_full["sim_yr_per_day"],
        "wall_s": r_full["wall_s"],
        "output_gb": round(r_full["output_bytes"] / 2 ** 30, 3),
        "checkpoint_every": CKPT_EVERY, "chunk_years": CHUNK,
        "resume_start_year": r_res["start_year"],
        "resume_state_bitexact": ok_state,
        "resume_output_bitexact": ok_out,
        "ts_mean_K": round(r_full["ts_mean_K"], 3),
        "state_sha": r_full["state_sha"],
        "output_sha": r_full["output_sha"],
    }
    print(json.dumps(summary, indent=2))
    assert ok_state, "resumed state != uninterrupted state"
    assert ok_out, "resumed output file != uninterrupted output file"


if __name__ == "__main__":
    main()
