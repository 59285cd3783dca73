"""The 1000-year config-5 pattern, FOR REAL, on one device (VERDICT r2 #2).

Runs the flagship long integration end-to-end: 96x48, 3-yr flux correction,
1000 scenario years at 2xCO2 through the CLI's fast circulation path,
with the monthly output stream ON (1000 x 12 x 5 records = 1.05 GB) and
periodic checkpoints — then a KILLED-AND-RESUMED variant in a fresh
process, proven bit-exact against the uninterrupted run (state AND output
file bytes).  The reference cannot restart at all: its output holds
monthly means only (src/greb.f90:978-982).

Usage:
  python tools/run1000.py             # orchestrates all phases, prints JSON
  python tools/run1000.py full DIR    # phase: uninterrupted 1000 yr
  python tools/run1000.py part DIR N  # phase: run to year N, then 'crash'
  python tools/run1000.py resume DIR  # phase: fresh process resumes to 1000

The parent process stays off JAX and runs the phases one at a time, so
only one process holds the device.
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

YEARS = int(os.environ.get("GREB_RUN1000_YEARS", "1000"))
# checkpoint cadence = run_long chunk
CHUNK = int(os.environ.get("GREB_RUN1000_CHUNK", "100"))
CKPT_EVERY = int(os.environ.get("GREB_RUN1000_CKPT", "100"))


def _model():
    from greb_tpu.config import GrebConfig, Numerics
    from greb_tpu.model.driver import GREB
    num = Numerics(time_flux=3, time_scnr=YEARS)
    return GREB(GrebConfig(numerics=num, fast_circulation=True),
                verbose=False)


def _run(workdir: str, stop_year, resume: bool) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from greb_tpu.forcing import Corrections
    from greb_tpu.io.checkpoint import Checkpointer
    from greb_tpu.model import longrun
    from greb_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    m = _model()
    ck = Checkpointer(os.path.join(workdir, "ck"), every_years=CKPT_EVERY)
    out_path = os.path.join(workdir, "scenario")
    runner = longrun.driver_year_runner(m, output_path=out_path)
    co2 = np.full(YEARS, 680.0, np.float32)

    if resume:
        # garbage inputs prove the checkpoint supplies everything
        state = jax.tree.map(jnp.zeros_like, m.initial_state())
        corr = Corrections.zeros(m.num.nstep_yr, m.num.ydim, m.num.xdim)
        t_fc = 0.0
    else:
        t0 = time.perf_counter()
        state, corr = m.flux_correction()
        t_fc = time.perf_counter() - t0

    # warm the scenario-year program (one discarded year) so the timed run
    # reports steady-state throughput; compile time goes in compile_s
    t0 = time.perf_counter()
    m.run_scenario(corr, state=m.initial_state(), years=1,
                   co2_series=co2[:1])
    compile_s = time.perf_counter() - t0

    target = stop_year if stop_year else YEARS
    t0 = time.perf_counter()
    state, corr, start = longrun.run_long(
        target, state, corr, co2, runner, checkpointer=ck,
        chunk_years=CHUNK)
    wall = time.perf_counter() - t0
    ts = np.asarray(state.ts)
    res = {
        "years_run": target - start, "start_year": start, "wall_s": wall,
        "sim_yr_per_s": (target - start) / wall if wall else 0.0,
        "flux_corr_s": t_fc, "compile_s": compile_s,
        "ts_mean_K": float(ts.mean()), "ts_min": float(ts.min()),
        "ts_max": float(ts.max()),
        "state_sha": hashlib.sha256(
            b"".join(np.asarray(getattr(state, f)).tobytes()
                     for f in ("ts", "ta", "to", "q", "cap_surf"))
        ).hexdigest()[:16],
    }
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

    base = os.environ.get("GREB_RUN1000_DIR",
                          os.path.join(tempfile.gettempdir(), "greb_run1000"))
    # a stale workdir makes run_long silently RESUME from old checkpoints
    # and measure a no-op (this bit a round-5 measurement) — start clean
    import shutil
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base, exist_ok=True)

    def phase(*args, timeout=3600):
        p = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                           capture_output=True, text=True, timeout=timeout)
        for ln in p.stdout.splitlines():
            if ln.startswith("PHASE_RESULT "):
                return json.loads(ln[len("PHASE_RESULT "):])
        sys.stderr.write(p.stdout[-2000:] + p.stderr[-4000:])
        raise SystemExit(f"phase {args} failed rc={p.returncode}")

    d_full = os.path.join(base, "full")
    d_res = os.path.join(base, "resumed")
    print(f"# uninterrupted {YEARS}-yr run ...", file=sys.stderr)
    r_full = phase("full", d_full)
    print(f"#   {r_full['sim_yr_per_s']:.1f} sim-yr/s, "
          f"Ts mean {r_full['ts_mean_K']:.2f} K", file=sys.stderr)
    half = (YEARS // 2 // CKPT_EVERY) * CKPT_EVERY
    print(f"# interrupted run: to year {half}, then killed ...",
          file=sys.stderr)
    r_part = phase("part", d_res, str(half))
    print(f"# fresh-process resume to {YEARS} ...", file=sys.stderr)
    r_res = phase("resume", d_res)
    ok_state = r_res["state_sha"] == r_full["state_sha"]
    ok_out = r_res.get("output_sha") == r_full.get("output_sha")
    summary = {
        "years": YEARS, "grid": "96x48",
        "sim_yr_per_s": round(r_full["sim_yr_per_s"], 2),
        "wall_s": round(r_full["wall_s"], 2),
        "compile_s": round(r_full["compile_s"], 2),
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
