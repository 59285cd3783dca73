"""High-level model driver: the JAX equivalent of PROGRAM greb_run +
subroutine greb_model (reference src/greb.f90:161-236, 996-1098) and of the
legacy experiment shell (src/greb.original.shell.web-public.f90).

Orchestration is year-granular: each phase compiles one jitted year-runner
and calls it per simulated year (host overhead per call is microseconds
against ~seconds of device work).
"""
from __future__ import annotations

import functools
import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GrebConfig, PhysicsParams, config_from_namelist
from ..forcing import (ClimForcing, Corrections, ModelState, apply_experiment,
                       build_derived, initial_state, load_forcing,
                       synthetic_forcing)
from ..grid import make_grid, month_average_matrix
from ..ops import stencils as stc
from . import core

F32 = np.float32


class GREB:
    """A configured GREB model instance bound to a forcing dataset."""

    def __init__(self, cfg: GrebConfig, params: Optional[PhysicsParams] = None,
                 forcing: Optional[ClimForcing] = None,
                 input_dir: Optional[str] = None,
                 extend: stc.Extend = stc.extend_lat_zero,
                 verbose: bool = True):
        self.cfg = cfg
        self.num = cfg.numerics
        self.exp = cfg.experiment
        self.params = params if params is not None else PhysicsParams.default()
        self.verbose = verbose and cfg.diagnostics.console
        self._extend = extend

        if forcing is None:
            forcing = (load_forcing(input_dir, self.num) if input_dir
                       else synthetic_forcing(self.num))
        forcing = apply_experiment(forcing, self.params, self.exp)
        self.forcing = forcing

        # extension-mode stability budgets must see the real forcing winds
        # (advisor r3: the 13 m/s design bound was silently assumed); the
        # PER-ROW wind bounds additionally derive wind-aware advective
        # sub-cycle counts (per-iteration Courant <= 0.8 by construction,
        # and far shallower schedules where polar winds are weak)
        uabs = np.abs(np.asarray(forcing.uclim))
        self.grid = make_grid(self.num.xdim, self.num.ydim, self.num.dt_crcl,
                              kappa=float(self.params.kappa),
                              pi=float(self.params.pi),
                              max_wind=float(uabs.max()),
                              u_rowmax=uabs.max(axis=(0, 2)))
        self.st, sf_np = stc.make_stencil_arrays(self.grid,
                                                 cfg.fidelity_jp2_quirk)
        self.sf = jax.tree.map(jnp.asarray, sf_np)
        self.derived = build_derived(self.params, forcing)
        self.md = core.ModelData(params=self.params, derived=self.derived,
                                 z_topo=forcing.z_topo, glacier=forcing.glacier,
                                 sf=self.sf)
        self.sfx = core.step_forcing_from_clim(forcing)
        self.month_mat = jnp.asarray(
            month_average_matrix(self.num.jday_mon, self.num.ndt_days))
        self._jit_cache = {}
        self._fastcirc = None  # lazy (FastPlan, FastConst, FastCoeffs)

    # -- factory ------------------------------------------------------------
    @classmethod
    def from_namelist(cls, path: str, **kw) -> "GREB":
        cfg, params = config_from_namelist(path)
        return cls(cfg, params=params, **kw)

    # -- fast-circulation constants -------------------------------------------
    def fastcirc_tables(self):
        """Lazy (FastPlan, FastConst) for the coefficient-folded circulation;
        None when disabled or unsupported (legacy transport overrides change
        the circulation operator itself).  Per-step coefficients are
        assembled on device from these constants + the step's winds."""
        if not self.cfg.fast_circulation:
            return None
        e = self.exp
        if e.circulation_off or e.vapor_circulation_off or e.vapor_diffusion_only:
            return None
        if self._fastcirc is None:
            if getattr(self.cfg, "fastcirc_version", 2) == 2:
                from ..ops import fastcirc2 as fc
            else:
                from ..ops import fastcirc as fc
            self._fastcirc = fc.build_const(
                np.asarray(self.derived.wz_air),
                np.asarray(self.derived.wz_vapor),
                self.grid, self.st, kappa=float(self.params.kappa))
        return self._fastcirc

    def _fastcirc_split(self):
        """(static plan, device-array data) — the data travels as jit
        ARGUMENTS, so it is not embedded in the compiled program as
        constants."""
        fcirc = self.fastcirc_tables()
        if fcirc is None:
            return None, None
        plan, const = fcirc
        return plan, (const,)

    # -- jitted year runners --------------------------------------------------
    def _year_fluxcorr(self):
        if "flux" not in self._jit_cache:
            plan, _ = self._fastcirc_split()
            f = functools.partial(core.run_year_fluxcorr, st=self.st,
                                  num=self.num, exp=self.exp,
                                  extend=self._extend,
                                  unroll_circ=self.cfg.unroll_circulation)

            def wrapper(state, sfx, co2, md, fcdata=None):
                fcirc = ((plan,) + tuple(fcdata)) if fcdata is not None else None
                return f(state, sfx, co2, md, fastcirc=fcirc)

            self._jit_cache["flux"] = jax.jit(wrapper)
        return self._jit_cache["flux"]

    def _year_scenario(self, with_outputs: bool = True):
        key = ("scnr", with_outputs)
        if key not in self._jit_cache:
            plan, _ = self._fastcirc_split()
            f = functools.partial(core.run_year_scenario, st=self.st,
                                  num=self.num, exp=self.exp,
                                  month_mat=self.month_mat,
                                  extend=self._extend,
                                  unroll_circ=self.cfg.unroll_circulation,
                                  with_outputs=with_outputs)

            def wrapper(state, sfx, corr, co2, md, fcdata=None):
                fcirc = ((plan,) + tuple(fcdata)) if fcdata is not None else None
                return f(state, sfx, corr, co2, md, fastcirc=fcirc)

            self._jit_cache[key] = jax.jit(wrapper)
        return self._jit_cache[key]

    # -- phases ---------------------------------------------------------------
    def initial_state(self) -> ModelState:
        return initial_state(self.params, self.forcing, self.derived)

    def flux_correction(self, state: Optional[ModelState] = None,
                        co2: Optional[float] = None
                        ) -> Tuple[ModelState, Corrections]:
        """Spin-up phase learning the 730-slot correction tables
        (reference src/greb.f90:311-364).  Returns the end-of-phase state
        (whose cap_surf carries into the scenario) and the tables."""
        num = self.num
        state = state if state is not None else self.initial_state()
        co2v = jnp.float32(co2 if co2 is not None
                           else (self.exp.co2_ctrl if self.exp.active
                                 else self.cfg.co2.co2_flux))
        if self.verbose:
            print(f"% FLUX CORRECTION RUN; years = {num.time_flux} "
                  f"co2 = {float(co2v)}")
        corr = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
        runner = self._year_fluxcorr()
        _, fcdata = self._fastcirc_split()
        for _ in range(num.time_flux):
            state, corr = runner(state, self.sfx, co2v, self.md, fcdata)
        return state, corr

    def run_scenario(self, corr: Corrections,
                     state: Optional[ModelState] = None,
                     years: Optional[int] = None,
                     co2_series: Optional[np.ndarray] = None,
                     output_path: Optional[str] = None,
                     cap_surf: Optional[jax.Array] = None,
                     collect_monthly: bool = True,
                     output_start_record: Optional[int] = None,
                     output_truncate: bool = True):
        """Scenario phase (reference src/greb.f90:223-234).

        Returns (state, monthly (years,12,5,y,x) | None, diag list)."""
        num = self.num
        years = years if years is not None else num.time_scnr
        if co2_series is None:
            co2_series = core.co2_series_for_run(
                num, self.exp, self.cfg.co2.series(num.time_scnr))
        co2_series = np.asarray(co2_series, F32)
        assert len(co2_series) >= years

        if state is None:
            state = self.initial_state()
            if cap_surf is not None:
                # cap_surf carries over from the flux-correction phase
                # (module variable in the reference; src/greb.f90:190,226)
                state = state.replace(cap_surf=cap_surf)

        writer = None
        if output_path:
            from ..io.binio import OutputWriter
            writer = OutputWriter(output_path, num.xdim, num.ydim,
                                  start_record=output_start_record,
                                  truncate=output_truncate)

        jit_runner = self._year_scenario(with_outputs=collect_monthly)
        _, fcdata = self._fastcirc_split()
        if self.verbose:
            print(f"% MODEL RUN; years = {years}")
            print("console output: year, co2, global avg temp, "
                  "avg temp for ipx/ipy")
        monthly_all, diags = [], []
        ft_mean, fq_mean = core.correction_annual_means(corr)
        year = num.year0
        for iy in range(years):
            co2 = jnp.float32(co2_series[iy])
            state, monthly, mean_fields = jit_runner(state, self.sfx, corr,
                                                     co2, self.md, fcdata)
            every = self.cfg.check_finite_every
            if every and (iy + 1) % every == 0:
                from ..diag.profiling import check_finite
                check_finite(state, name=f"state@yr{iy + 1}")
            if collect_monthly:
                monthly_np = np.asarray(monthly)
                monthly_all.append(monthly_np)
                if writer:
                    writer.write_months(monthly_np)
                diag = core.year_diag(mean_fields, num)._replace(
                    ft_mean=ft_mean, fq_mean=fq_mean)
                diags.append(diag)
                if self.verbose:
                    print(f" {year + 1} {float(co2):10.4f} "
                          f"{float(diag.global_mean_ts) - 273.15:12.6f} "
                          f"{float(diag.point_ts) - 273.15:12.6f}")
            year += 1
        if writer:
            writer.close()
        monthly_arr = np.stack(monthly_all) if monthly_all else None
        return state, monthly_arr, diags

    # -- the reference's full default workload --------------------------------
    def run(self, output_path: Optional[str] = None):
        """Full reference workload: flux correction then scenario
        (greb_model, src/greb.f90:161-236)."""
        t0 = time.perf_counter()
        state_fc, corr = self.flux_correction()
        out_path = output_path if output_path is not None else (
            self.cfg.diagnostics.output_file_full or None)
        # the scenario CONTINUES from the spin-up end state (the reference's
        # module arrays persist across phases, src/greb.f90:219-234; Ts/q/To
        # are pinned to climatology by the corrections but Ta is free)
        state, monthly, diags = self.run_scenario(
            corr, state=state_fc, output_path=out_path)
        if self.verbose:
            dt = time.perf_counter() - t0
            tot = self.num.time_flux + self.num.time_scnr
            print(f"% done: {tot} sim-years in {dt:.2f}s "
                  f"({tot / dt:.1f} sim-yr/s)")
        return state, corr, monthly, diags

    def run_control(self, corr: Corrections,
                    state_fc: Optional[ModelState] = None,
                    output_path: Optional[str] = None):
        """Legacy control-run phase at CO2_ctrl, starting from the spin-up
        end state (greb.original.model.f90:208-215; Ts_ini was mutated in
        place by qflux_correction at :201).

        The reference REWINDS the control unit to record 1 (irec=0 at :211)
        after the 730-record TF_correct dump (:204-206) WITHOUT truncating:
        the control run's 60*time_ctrl monthly records overwrite the head of
        the dump and TF records 60*time_ctrl+1..730 survive in the tail —
        reproduced here via direct-access overwrite semantics."""
        num = self.num
        co2 = np.full(max(num.time_ctrl, 1), self.exp.co2_ctrl, F32)
        return self.run_scenario(corr, years=num.time_ctrl, co2_series=co2,
                                 output_path=output_path, state=state_fc,
                                 output_start_record=0,
                                 output_truncate=False)
