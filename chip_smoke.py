"""Smoke test of GREB on NVIDIA GPUs: the main path end to end, checked.

    python chip_smoke.py               # one GPU: phases 1-6 below
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

One card, all in this one process (a second JAX process could not get the
card's memory):

1. device check: refuses anything but a GPU; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. golden year at 96x48, full calendar: 1 flux-correction year (co2=298)
   and 1 scenario year (co2=680), strict and fast circulation, against
   tests/golden/golden_year_96x48.npz under tests/test_golden_year.py's
   tolerances;
3. the CLI (``greb_tpu.__main__.main``) with a namelist, 1 flux + 3
   scenario years; its output file is compared record for record with the
   same run through ``GREB.run``, and the main path's warm sim-yr/s is
   timed;
4. ``--checkpoint-dir`` then ``--resume``: the resumed output file and
   final checkpoint are bit-identical to an uninterrupted run;
5. ``--ensemble 8``: output against the vmapped elementwise-fold ensemble,
   and the error of ``--mxu-precision high`` (TF32) against it;
6. the bodies of the tests marked ``gpu``, with their own set-up, as
   functions in this process.

Four cards: the latitude halo exchange against a NumPy shift (bit for
bit); an ('ens'=2, 'y'=2) mesh with 4 members at 96x48 against the vmapped
one-card ensemble; a ('y'=4) mesh at 384x192 against the same per-shard
program on one card (2e-2 K over the first two months) and against the
unsharded fast path on one card (5e-2 K there), and against both under
tests/test_sharded_fast.py's tolerance (5e-2 K) over the full year.

Every phase that fails raises, and the script exits non-zero.  The last
line of standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "golden_year_96x48.npz")
F32 = np.float32


def _log(msg: str) -> None:
    print(msg, flush=True)


def _num(**kw):
    from greb_tpu.config import Numerics
    return Numerics(**kw)


def _forcing96(num):
    from greb_tpu.forcing import forcing_from_arrays
    from greb_tpu.io.synthetic import make_synthetic_forcing
    return forcing_from_arrays(
        make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr))


def _require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _check(name: str, value: float, bound: float) -> str:
    """'name=value (bound)'; raises AssertionError past the bound."""
    _require(value <= bound, f"{name} = {value!r} exceeds {bound!r}")
    return f"{name}={value:.3g} (<= {bound:g})"


def _max_rms(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()), float(np.sqrt((d ** 2).mean()))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_golden(golden_path: str = GOLDEN,
                 paths=(("strict", False), ("fast", True))) -> dict:
    """Phase 2: 1+1 golden years at 96x48 against the oracle's artifact."""
    from tests.test_golden_year import golden_checks, run_golden_year
    golden = np.load(golden_path)
    num = _num(time_flux=1, time_scnr=1)
    forcing = _forcing96(num)
    out = {}
    for name, fast in paths:
        _, state_fc, corr, state, monthly = run_golden_year(
            forcing, fast_circulation=fast)
        checks = golden_checks(golden, state_fc, corr, state, monthly)
        _log(f"  golden[{name}]: " + ", ".join(
            _check(n, d, b) for n, d, b in checks))
        out[name] = {n: d for n, d, _ in checks}
    return out


def _write_namelist(path: str, flux: int, scnr: int, output: str) -> None:
    from greb_tpu.io.namelist import write_namelist
    write_namelist({"numerics_par": {"time_flux": flux, "time_scnr": scnr},
                    "diagnostics_par": {"output_file": output},
                    "co2_par": {"co2_ppm": [680.0]}}, path)


def phase_cli(workdir: str, flux: int = 1, scnr: int = 3) -> dict:
    """Phase 3: the CLI against GREB.run, and the warm main-path rate."""
    from greb_tpu.__main__ import main as cli
    from greb_tpu.config import config_from_namelist
    from greb_tpu.io.binio import read_output
    from greb_tpu.model.driver import GREB
    import dataclasses

    nml = os.path.join(workdir, "namelist")
    out = os.path.join(workdir, "cli", "scenario")
    _write_namelist(nml, flux, scnr, out)
    t0 = time.perf_counter()
    _require(cli([nml, "--synthetic", "--quiet"]) == 0, "CLI run failed")
    cli_s = time.perf_counter() - t0
    back = read_output(out, 96, 48)

    # the same run through the library, as the CLI builds it
    cfg, params = config_from_namelist(nml)
    cfg = dataclasses.replace(cfg, fast_circulation=True)
    m = GREB(cfg, params=params, verbose=False)
    lib_out = os.path.join(workdir, "lib", "scenario")
    os.makedirs(os.path.dirname(lib_out), exist_ok=True)
    t0 = time.perf_counter()
    _, _, monthly, _ = m.run(output_path=lib_out)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, monthly, _ = m.run(output_path=lib_out)
    warm_s = time.perf_counter() - t0
    want = monthly.reshape(-1, 5, 48, 96)
    _require(back.shape == want.shape, f"{back.shape} != {want.shape}")
    _require(np.isfinite(back).all(), "CLI output is not finite")
    d, _ = _max_rms(back, want)
    rate = (flux + scnr) / warm_s
    _log(f"  cli: {back.shape[0]} months x 5 fields read back, "
         + _check("max|cli-lib|", d, 0.0)
         + f"; cli wall {cli_s:.2f} s (with compile), library first run "
         f"{first_s:.2f} s, warm {warm_s:.3f} s")
    return {"months": int(back.shape[0]), "cli_s": cli_s,
            "first_run_s": first_s, "warm_s": warm_s,
            "sim_yr_per_s": rate}


def phase_resume(workdir: str, flux: int = 1, scnr: int = 3) -> dict:
    """Phase 4: checkpointed run, interrupted and resumed, vs uninterrupted."""
    from greb_tpu.__main__ import main as cli

    def run(tag, years, resume):
        nml = os.path.join(workdir, f"namelist_{tag}_{years}")
        out = os.path.join(workdir, tag, "scenario")
        ck = os.path.join(workdir, tag, "ck")
        _write_namelist(nml, flux, years, out)
        argv = [nml, "--synthetic", "--quiet", "--checkpoint-dir", ck,
                "--checkpoint-every", "1"] + (["--resume"] if resume else [])
        _require(cli(argv) == 0, f"CLI run failed: {argv}")
        return out, ck

    out_a, ck_a = run("full", scnr, False)
    run("part", scnr - 1, False)            # 'crash' after scnr-1 years
    out_b, ck_b = run("part", scnr, True)   # fresh model resumes to scnr
    with open(out_a, "rb") as fa, open(out_b, "rb") as fb:
        a, b = fa.read(), fb.read()
    _require(len(a) == len(b) and a == b, "resumed output differs")
    last = f"ckpt_{scnr - 1:06d}"
    za = np.load(os.path.join(ck_a, last, "state.npz"))
    zb = np.load(os.path.join(ck_b, last, "state.npz"))
    for k in za.files:
        _require(np.array_equal(za[k], zb[k]), f"resumed {k} differs")
    _log(f"  resume: output ({len(a)} bytes) and final checkpoint "
         f"({', '.join(za.files)}) bit-identical")
    return {"output_bytes": len(a), "bitexact": True}


def phase_ensemble(workdir: str, members: int = 8) -> dict:
    """Phase 5: --ensemble M (highest) vs the vmapped elementwise fold, and
    the error of precision "high" against the same reference."""
    import jax.numpy as jnp
    from greb_tpu.__main__ import main as cli
    from greb_tpu.config import GrebConfig
    from greb_tpu.io.binio import read_output
    from greb_tpu.model.driver import GREB
    from greb_tpu.ops import fastcirc2 as fc2
    from greb_tpu.parallel import ensemble as ens

    nml = os.path.join(workdir, "namelist_ens")
    out = os.path.join(workdir, "ens", "scenario")
    _write_namelist(nml, 1, 1, out)
    argv = [nml, "--synthetic", "--quiet", "--ensemble", str(members),
            "--perturb", "ct_sens=22.05:22.95"]
    _require(cli(argv) == 0, f"CLI run failed: {argv}")

    m = GREB(GrebConfig(numerics=_num(time_flux=1, time_scnr=1),
                        fast_circulation=True), verbose=False)
    sweep = np.linspace(22.05, 22.95, members).astype(F32)
    pb = ens.perturbed_params(m.params, {"ct_sens": sweep})
    md_v = ens.ensemble_data(pb, m.forcing, m.sf)
    state0 = ens.ensemble_initial_state(pb, m.forcing, md_v)
    plan, (const,) = m._fastcirc_split()
    co2f, co2s = jnp.float32(298.0), jnp.float32(680.0)
    flux_v, scnr_v = ens.make_ensemble_runners(m.st, m.num, m.exp,
                                               m.month_mat, fast_plan=plan)
    sv, corr_v = flux_v(state0, m.sfx, co2f, md_v, (const,))
    sv, mon_v, _ = scnr_v(sv, m.sfx, corr_v, co2s, md_v, (const,))
    mon_v = np.asarray(mon_v)

    cli_d = max(_max_rms(read_output(f"{out}_{i + 1:03d}", 96, 48),
                         mon_v[i].reshape(-1, 5, 48, 96))[0]
                for i in range(members))

    md_b = ens.batched_model_data(pb, m.forcing, m.sf)
    mxu = fc2.build_mxu(const, plan, precision="high", mode="stacked")
    flux_b, scnr_b = ens.make_batched_ensemble_runners(
        m.st, m.num, m.exp, m.month_mat, fast_plan=plan)
    sb, corr_b = flux_b(state0, m.sfx, co2f, md_b, (const, mxu))
    sb, mon_b, _ = scnr_b(sb, m.sfx, corr_b, co2s, md_b, (const, mxu))
    mon_max, mon_rms = _max_rms(mon_b, mon_v)
    ts_max, ts_rms = _max_rms(sb.ts, sv.ts)
    tf_max, _ = _max_rms(np.asarray(corr_b.tf).transpose(1, 0, 2, 3),
                         corr_v.tf)
    high = {"monthly_max": mon_max, "monthly_rms": mon_rms,
            "end_ts_max": ts_max, "end_ts_rms": ts_rms, "corr_tf_max": tf_max}
    _log(f"  ensemble[{members}]: "
         + _check("max|cli(highest)-fold| monthly", cli_d, 5e-3)
         + "; high(TF32) vs fold: " + ", ".join(
             f"{k}={v:.4g}" for k, v in high.items()))
    return {"cli_highest_monthly_max": cli_d, "high": high}


def phase_gpu_tests() -> dict:
    """Phase 6: the bodies of the tests marked ``gpu``, with their own
    set-up, in this process."""
    from tests.test_mxu import (GPU_HIGH_BOUNDS, M, check_high_error_gpu,
                                make_mxu_setup)
    from tests.test_runtime import check_require_gpu_on_card
    check_require_gpu_on_card()
    _log("  test_require_gpu_on_card: passed")
    errs = check_high_error_gpu(make_mxu_setup())
    _log(f"  test_mxu_high_error_budget_gpu ({M} members, 1+1 years, "
         "high vs fold): " + ", ".join(
             f"{k}={v:.4g} (< {GPU_HIGH_BOUNDS[k]:g})"
             for k, v in errs.items()) + ": passed")
    return {"mxu_high_error": errs}


def phase_members_mesh(members: int = 4, num_kw=None) -> dict:
    """Four cards: ('ens'=2, 'y'=2) mesh vs the vmapped one-card ensemble."""
    import jax
    import jax.numpy as jnp
    from greb_tpu.config import GrebConfig
    from greb_tpu.forcing import Corrections
    from greb_tpu.model.driver import GREB
    from greb_tpu.ops import fastcirc2 as fc2
    from greb_tpu.parallel import ensemble as ens
    from greb_tpu.parallel.sharded import (make_mesh, make_sharded_year_runners,
                                           shard_fastcirc, shard_inputs)

    num = _num(time_flux=1, time_scnr=1, **(num_kw or {}))
    m = GREB(GrebConfig(numerics=num, fast_circulation=True), verbose=False)
    co2f, co2s = jnp.float32(298.0), jnp.float32(680.0)
    pb = ens.perturbed_params(
        m.params, {"ct_sens": F32(22.5) + F32(0.1) * np.arange(members,
                                                              dtype=F32)})
    md_b = ens.ensemble_data(pb, m.forcing, m.sf)
    state_b = ens.ensemble_initial_state(pb, m.forcing, md_b)
    plan, (const,) = m._fastcirc_split()
    flux_v, scnr_v = ens.make_ensemble_runners(m.st, num, m.exp, m.month_mat,
                                               fast_plan=plan)
    s_v, corr_v = flux_v(state_b, m.sfx, co2f, md_b, (const,))
    s_v, mon_v, _ = scnr_v(s_v, m.sfx, corr_v, co2s, md_b, (const,))

    mesh = make_mesh(n_ens=2, n_y=2)
    splan, sconst = fc2.build_sharded(
        np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
        m.grid, m.st, kappa=float(m.params.kappa), n_shards=2)
    flux_sh, scnr_sh = make_sharded_year_runners(
        mesh, m.st, num, m.exp, m.month_mat, batched=True, fast_plan=splan)
    corr0 = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (members,) + a.shape),
        Corrections.zeros(num.nstep_yr, num.ydim, num.xdim))
    state_s, sfx_s, _, md_s = shard_inputs(mesh, True, state_b, m.sfx,
                                           corr0, md_b)
    sconst_sh = shard_fastcirc(mesh, sconst)
    s_sh, corr_sh = flux_sh(state_s, sfx_s, co2f, md_s, sconst_sh)
    s_sh, mon_sh, _ = scnr_sh(s_sh, sfx_s, corr_sh, co2s, md_s, sconst_sh)
    mon_max, _ = _max_rms(mon_sh, mon_v)
    ts_max, _ = _max_rms(s_sh.ts, s_v.ts)
    _log(f"  mesh(ens=2,y=2) {members} members {num.xdim}x{num.ydim}: "
         + _check("max|monthly|", mon_max, 2e-2) + ", "
         + _check("max|end ts|", ts_max, 2e-2))
    return {"monthly_max": mon_max, "end_ts_max": ts_max}


def phase_halo(rows: int = 192, cols: int = 384, n_y: int = 4) -> dict:
    """Four cards: the latitude halo exchange (``halo_exchange_lat``) over
    a ('y'=n_y) mesh moves exactly the neighbour rows a NumPy shift gives,
    zeros at the poles; two fields at the refined grid's shape."""
    import jax
    from jax.sharding import PartitionSpec as P
    from greb_tpu.parallel.halo import halo_exchange_lat
    from greb_tpu.parallel.sharded import _shard_map, make_mesh

    w, r = 2, rows // n_y
    x = np.random.default_rng(0).standard_normal((2, rows, cols)).astype(F32)
    fn = jax.jit(_shard_map(
        lambda b: halo_exchange_lat(b, w, "y", n_y),
        make_mesh(n_y=n_y), in_specs=P(None, "y", None),
        out_specs=P(None, "y", None)))
    got = np.asarray(fn(x)).reshape(2, n_y, r + 2 * w, cols)
    pad = np.pad(x, ((0, 0), (w, w), (0, 0)))
    want = np.stack([pad[:, i * r:i * r + r + 2 * w] for i in range(n_y)],
                    axis=1)
    _require(np.array_equal(got, want), "halo exchange moved wrong rows")
    _log(f"  halo(y={n_y}) {rows}x{cols} x2 fields, width {w}: "
         "bit-identical to the NumPy shift")
    return {"bitexact": True}


def phase_refined_mesh(num_kw=None) -> dict:
    """Four cards: ('y'=4) mesh at 384x192, 1 scenario year with zero
    corrections, against (a) the same per-shard program on one card with
    the exchange done by indexing (``make_emulated_year_runners``: the
    exchange and the float32 summation order differ, not the fold) and (b)
    the unsharded fast path on one card, over the first two months (118
    steps) and over the full year.  Every comparison is printed before any
    failure is raised."""
    import jax
    import jax.numpy as jnp
    from greb_tpu.config import GrebConfig
    from greb_tpu.forcing import Corrections, forcing_from_arrays
    from greb_tpu.io.synthetic import make_synthetic_forcing
    from greb_tpu.model.driver import GREB
    from greb_tpu.ops import fastcirc2 as fc2
    from greb_tpu.parallel.sharded import (make_emulated_year_runners,
                                           make_mesh, make_sharded_year_runners,
                                           shard_fastcirc, shard_inputs)
    from greb_tpu.regrid import regrid_forcing_arrays

    num = _num(**(dict(xdim=384, ydim=192, time_flux=0, time_scnr=1)
                  | (num_kw or {})))
    arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
    m = GREB(GrebConfig(numerics=num, fast_circulation=True),
             forcing=forcing_from_arrays(regrid_forcing_arrays(arrs, num)),
             verbose=False)
    co2 = jnp.float32(680.0)
    corr0 = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    state0 = m.initial_state()
    _, fcdata = m._fastcirc_split()
    year = m._year_scenario()
    s_ref, mon_ref, _ = year(state0, m.sfx, corr0, co2, m.md, fcdata)

    splan, sconst = fc2.build_sharded(
        np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
        m.grid, m.st, kappa=float(m.params.kappa), n_shards=4)
    _, scnr_emu = make_emulated_year_runners(4, m.st, num, m.exp,
                                             m.month_mat, fast_plan=splan)
    s_emu, mon_emu, _ = scnr_emu(state0, m.sfx, corr0, co2, m.md, sconst)

    mesh = make_mesh(n_ens=1, n_y=4)
    _, scnr_sh = make_sharded_year_runners(mesh, m.st, num, m.exp,
                                           m.month_mat, fast_plan=splan)
    state_s, sfx_s, corr_s, md_s = shard_inputs(mesh, False, state0, m.sfx,
                                                corr0, m.md)
    sconst_sh = shard_fastcirc(mesh, sconst)
    s_sh, mon_sh, _ = scnr_sh(state_s, sfx_s, corr_s, co2, md_s, sconst_sh)
    _require(np.isfinite(np.asarray(mon_sh)).all(), "sharded run not finite")
    # one more warm year each: the time of a year on 1 and on 4 devices
    t0 = time.perf_counter()
    jax.block_until_ready(year(s_ref, m.sfx, corr0, co2, m.md, fcdata))
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(scnr_sh(s_sh, sfx_s, corr_s, co2, md_s, sconst_sh))
    four_s = time.perf_counter() - t0

    mon_sh, s_sh_ts = np.asarray(mon_sh), np.asarray(s_sh.ts)
    r_blk = num.ydim // 4
    edge = [k * r_blk + d for k in (1, 2, 3) for d in (-2, -1, 0, 1)]
    res, failed = {"year_s_1dev": one_s, "year_s_4dev": four_s}, []
    # Against the emulation the float32 summation order still differs (the
    # batched one-card program vs the per-card ones), and the polar
    # composites carry it into the conserved zonal mean: 4.8e-3 K after
    # 118 steps on H100s.  A fault in the exchange moves rows by kelvins
    # within 20 steps (a reversed or misplaced halo row: 1.8 K to 33 K).
    for ref, mon, ts, bound_2m in (("emulated", mon_emu, s_emu.ts, 2e-2),
                                   ("unsharded", mon_ref, s_ref.ts, 5e-2)):
        mon, ts = np.asarray(mon), np.asarray(ts)
        d_ts = np.abs(s_sh_ts.astype(np.float64) - ts)
        r = {"months12_max": _max_rms(mon_sh[:2], mon[:2])[0]}
        r["monthly_max"], r["monthly_rms"] = _max_rms(mon_sh, mon)
        r["end_ts_max"], r["end_ts_rms"] = _max_rms(s_sh_ts, ts)
        r["end_ts_row"] = int(np.unravel_index(d_ts.argmax(), d_ts.shape)[0])
        r["shard_edge_rows_monthly_max"] = _max_rms(mon_sh[..., edge, :],
                                                    mon[..., edge, :])[0]
        bounds = {"months12_max": bound_2m, "monthly_max": 5e-2,
                  "end_ts_max": 5e-2}
        parts = []
        for k, v in r.items():
            b = bounds.get(k)
            if b is not None and not v <= b:
                failed.append(f"4 cards vs {ref}: {k} = {v!r} exceeds {b!r}")
            parts.append(f"{k}={v:.4g}" + ("" if b is None else
                         f" ({'<=' if v <= b else 'FAILS'} {b:g})"))
        _log(f"  mesh(y=4) {num.xdim}x{num.ydim} ({num.nstep_yr} steps) vs "
             f"{ref} on one card: " + ", ".join(parts))
        res[ref] = r
    _log(f"  warm year {one_s:.3f} s unsharded on 1 device, {four_s:.3f} s "
         "on 4")
    _require(not failed, "; ".join(failed))
    return res


# ---------------------------------------------------------------------------
def _phase(results: dict, name: str, fn, *args, **kw):
    _log(f"== {name}")
    t0 = time.perf_counter()
    results[name] = fn(*args, **kw)
    _log(f"   {name} ok in {time.perf_counter() - t0:.1f} s")
    return results[name]


def run_one_card(workdir: str) -> dict:
    results = {}
    _phase(results, "golden", phase_golden)
    _phase(results, "cli", phase_cli, workdir)
    _phase(results, "resume", phase_resume, workdir)
    _phase(results, "ensemble", phase_ensemble, workdir)
    _phase(results, "gpu_tests", phase_gpu_tests)
    return results


def run_four_cards() -> dict:
    results = {}
    _phase(results, "halo", phase_halo)
    _phase(results, "members_mesh", phase_members_mesh)
    _phase(results, "refined_mesh", phase_refined_mesh)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax
    from greb_tpu.runtime import (enable_compile_cache,
                                  gpu_name_and_power_limit, require_gpu)
    try:
        dev = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    n_dev = len(jax.devices())
    need = 4 if args.four_cards else 1
    if n_dev < need:
        print(f"chip_smoke: needs {need} GPUs, JAX has {n_dev}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    _log(f"device: {dev.platform} {dev.device_kind} x{n_dev}")
    _log(f"nvidia-smi: {gpu_name_and_power_limit()}")
    t0 = time.perf_counter()
    if args.four_cards:
        results = run_four_cards()
    else:
        with tempfile.TemporaryDirectory() as workdir:
            results = run_one_card(workdir)
    _log(f"results: {json.dumps(results)}")
    _log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n_dev}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
