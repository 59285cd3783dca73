"""CLI entry point: ``python -m greb_tpu [namelist] [options]``.

The equivalent of the reference's ``./greb [namelist]``
(PROGRAM greb_run, reference src/greb.f90:996-1098): the positional argument
is a Fortran namelist path (default ``namelist``), input climatologies are
read from ``--input-dir`` in the reference's direct-access binary format
(or synthesized with ``--synthetic``), and output is the reference's
5-variable monthly-mean record stream.

Extras beyond the reference CLI:
  --checkpoint-dir    periodic checkpoint/resume (the reference has none)
  --legacy            run the legacy experiment workflow for the namelist's
                      log_exp (control + scenario phases, TF_correct dump;
                      cf. src/greb.original.model.f90:199-231)
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m greb_tpu",
        description="GREB climate model in JAX")
    p.add_argument("namelist", nargs="?", default="namelist",
                   help="namelist path (default: ./namelist, like ./greb)")
    p.add_argument("--input-dir", default=None,
                   help="directory with reference-format binary inputs; "
                        "omit to use the deterministic synthetic climatology")
    p.add_argument("--synthetic", action="store_true",
                   help="force synthetic forcing even if --input-dir is set")
    p.add_argument("--output", default=None,
                   help="override diagnostics_par output_file")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="years between checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--legacy", action="store_true",
                   help="legacy experiment workflow (log_exp switchboard)")
    p.add_argument("--strict-circulation", action="store_true",
                   help="strict term-by-term stencils instead of the "
                        "coefficient-folded fast circulation (bit-level "
                        "fidelity mode; slower)")
    p.add_argument("--plots", default=None, metavar="PREFIX",
                   help="after the run, write the reference README's figure "
                        "set (warming curve, Arctic albedo, dTsurf, inputs) "
                        "as PREFIX_*.png")
    p.add_argument("--ensemble", type=int, default=0, metavar="M",
                   help="run an M-member perturbed-physics ensemble batched "
                        "on one device (the reference runs one process per "
                        "member via ens_id, src/greb.f90:1064-1068); each "
                        "member's monthly records go to output_file_<i>")
    p.add_argument("--perturb", default="ct_sens=22.05:22.95",
                   metavar="PARAM=LO:HI",
                   help="ensemble perturbation: PhysicsParams field swept "
                        "linearly across members (default ct_sens, +-2%%)")
    p.add_argument("--shared-spinup", action="store_true",
                   help="ensemble mode: one BASE-params flux-correction "
                        "spin-up shared by every member (the standard "
                        "perturbed-physics-ensemble setup) instead of "
                        "per-member spin-ups, which each keep 40 MB of "
                        "correction tables")
    p.add_argument("--mxu-precision", choices=("high", "highest"),
                   default="highest",
                   help="matmul precision of the ensemble's matmul "
                        "circulation: 'highest' (full float32, the "
                        "single-run fidelity contract; default) or 'high' "
                        "(TF32 tensor-core passes on an H100, ~10 mantissa "
                        "bits; error in PERF.md)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .config import GrebConfig, config_from_namelist
    from .runtime import enable_compile_cache
    from .model.driver import GREB

    if os.path.exists(args.namelist):
        cfg, params = config_from_namelist(args.namelist)
    else:
        if args.namelist != "namelist":
            print(f"namelist not found: {args.namelist}", file=sys.stderr)
            return 2
        cfg, params = GrebConfig(), None   # reference also runs w/o namelist
    if args.output:
        import dataclasses
        cfg = dataclasses.replace(
            cfg, diagnostics=dataclasses.replace(cfg.diagnostics,
                                                 output_file=args.output))
    import dataclasses
    # the coefficient-folded circulation is the production default for the
    # CLI (validated allclose vs the strict path; tests/test_fastcirc.py);
    # legacy experiments fall back automatically where unsupported
    cfg = dataclasses.replace(cfg,
                              fast_circulation=not args.strict_circulation)

    enable_compile_cache()
    input_dir = None if args.synthetic else args.input_dir
    model = GREB(cfg, params=params, input_dir=input_dir,
                 verbose=not args.quiet)

    out_path = cfg.diagnostics.output_file_full
    out_dir = os.path.dirname(out_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    t0 = time.perf_counter()
    monthly = diags = None
    if args.ensemble > 0:
        run_ensemble(model, out_path, args)
    elif args.legacy:
        run_legacy(model, out_path, quiet=args.quiet)
    elif args.checkpoint_dir:
        run_checkpointed(model, out_path, args)
    else:
        _, _, monthly, diags = model.run(output_path=out_path)
    if not args.quiet:
        print(f"% total wall time {time.perf_counter() - t0:.2f}s")
    if args.plots:
        if monthly is None:
            from .io.binio import read_output
            import numpy as np
            back = read_output(out_path, model.num.xdim, model.num.ydim)
            monthly = back.reshape(-1, 12, 5, model.num.ydim, model.num.xdim)
        from . import plots as figs
        paths = figs.save_all(args.plots, monthly, diags=diags,
                              forcing=model.forcing)
        if not args.quiet:
            print("% figures: " + " ".join(paths))
    return 0


def run_ensemble(model, out_path: str, args) -> None:
    """M-member perturbed-physics ensemble on one device: spin-up +
    scenario with the member axis batched through the matmul circulation
    (parallel/ensemble.py), per-member output streams with the reference's
    ens_id suffix convention (src/greb.f90:1064-1068)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .io.binio import OutputWriter
    from .ops import fastcirc2 as fc2
    from .parallel import ensemble as ens

    M = args.ensemble
    name, _, rng = args.perturb.partition("=")
    lo, _, hi = rng.partition(":")
    try:
        sweep = np.linspace(float(lo), float(hi), M).astype(np.float32)
    except ValueError:
        raise SystemExit(f"bad --perturb spec: {args.perturb!r} "
                         f"(want PARAM=LO:HI)")
    if not hasattr(model.params, name):
        raise SystemExit(f"unknown physics parameter: {name!r}")
    if not ens.fastcirc_shareable([name]):
        raise SystemExit(f"{name!r} perturbs the transport operator; "
                         f"batched ensembles share the folded circulation "
                         f"tables (see parallel.ensemble)")
    if not args.quiet:
        print(f"% ENSEMBLE RUN; members = {M} perturb {name} in "
              f"[{sweep[0]}, {sweep[-1]}] mxu={args.mxu_precision}")

    pb = ens.perturbed_params(model.params, {name: sweep})
    md_b = ens.batched_model_data(pb, model.forcing, model.sf)
    state_b = ens.ensemble_initial_state(
        pb, model.forcing, ens.ensemble_data(pb, model.forcing, model.sf))
    plan, fcd = model._fastcirc_split()
    if fcd is not None:
        (const,) = fcd
        fcdata = (const, fc2.build_mxu(const, plan,
                                       precision=args.mxu_precision,
                                       mode="stacked"))
    else:
        fcdata = None
    flux_b, scnr_b = ens.make_batched_ensemble_runners(
        model.st, model.num, model.exp, model.month_mat, fast_plan=plan)

    num = model.num
    co2_flux = jnp.float32(model.cfg.co2.co2_flux)
    if getattr(args, "shared_spinup", False):
        # one BASE-params spin-up, shared correction tables (member axis of
        # size 1 broadcasts through the batched runners) — the standard
        # perturbed-physics-ensemble configuration; removes the per-member
        # 40 MB correction tables
        state0, corr0 = model.flux_correction()
        corr_b = jax.tree.map(lambda a: a[:, None], corr0)
        state_b = state_b.replace(cap_surf=jnp.broadcast_to(
            state0.cap_surf[None], (M,) + state0.cap_surf.shape))
    else:
        for _ in range(num.time_flux):
            state_b, corr_b = flux_b(state_b, model.sfx, co2_flux, md_b,
                                     fcdata)

    co2_series = model.cfg.co2.series(num.time_scnr)
    writers = [OutputWriter(f"{out_path}_{i + 1:03d}", num.xdim, num.ydim)
               for i in range(M)]
    year = num.year0
    for iy in range(num.time_scnr):
        co2 = jnp.float32(co2_series[iy])
        state_b, monthly_b, mf_b = scnr_b(state_b, model.sfx, corr_b, co2,
                                          md_b, fcdata)
        mon_np = np.asarray(monthly_b)             # (M, nmon, 5, y, x)
        for i, w in enumerate(writers):
            w.write_months(mon_np[i])
        if not args.quiet:
            gm = np.asarray(mf_b.ts).mean(axis=(1, 2)) - 273.15
            print(f" {year + 1} {float(co2):10.4f} members "
                  f"[{gm.min():.4f} .. {gm.max():.4f}] degC")
        year += 1
    for w in writers:
        w.close()


def run_legacy(model, out_path: str, quiet: bool = False) -> None:
    """Legacy workflow (src/greb.original.model.f90:199-231): spin-up, dump
    TF_correct to <out>/control-prefix, control run, then scenario."""
    import numpy as np
    from .io.binio import write_records

    state_fc, corr = model.flux_correction()
    base = os.path.dirname(out_path) or "."
    os.makedirs(base, exist_ok=True)
    control_path = os.path.join(base, "control")
    # dump the 730 TF_correct records first (reference :204-206)
    write_records(control_path, np.asarray(corr.tf))
    # both the control and the scenario run start from the SPIN-UP END state:
    # the reference re-initializes from Ts_ini etc. (:210, :219), which
    # qflux_correction mutated in place (Fortran pass-by-reference, :201)
    if model.num.time_ctrl > 0:
        model.run_control(corr, state_fc=state_fc, output_path=control_path)
    model.run_scenario(corr, state=state_fc, output_path=out_path)


def run_checkpointed(model, out_path: str, args) -> None:
    """Scenario phase with periodic checkpoints and optional resume."""
    import numpy as np
    from .io.binio import OutputWriter
    from .io.checkpoint import Checkpointer, RunCursor

    ck = Checkpointer(args.checkpoint_dir, every_years=args.checkpoint_every)
    num = model.num
    co2_series = model.cfg.co2.series(num.time_scnr)

    start_year = 0
    if args.resume and ck.latest_step() is not None:
        state, corr, cursor = ck.restore()
        start_year = cursor.year_index
        if not args.quiet:
            print(f"% resumed from checkpoint at year {start_year}")
    else:
        state_fc, corr = model.flux_correction()
        state = state_fc          # phases continue from the spin-up end

    writer = OutputWriter(out_path, num.xdim, num.ydim,
                          append=start_year > 0)
    for iy in range(start_year, num.time_scnr):
        state, monthly, diags = model.run_scenario(
            corr, state=state, years=1,
            co2_series=co2_series[iy:iy + 1])
        writer.write_months(monthly[0])
        if ck.maybe_save(iy, state, corr,
                         RunCursor(phase="scenario", year_index=iy + 1,
                                   co2=float(co2_series[iy]))):
            if not args.quiet:
                print(f"% checkpoint saved at year {iy + 1}")
    writer.close()


if __name__ == "__main__":
    sys.exit(main())
