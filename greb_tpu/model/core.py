"""Model core: tendencies, time step, and the two integration phases.

Reproduces the reference control flow:
  greb_model (src/greb.f90:161-236)
    -> qflux_correction (:311-364)      [spin-up phase]
    -> scenario loop -> time_loop (:239-274) -> tendencies (:277-308)

Design: one 12-hour step is a pure function ``(state, step_forcing) ->
(state, outputs)``; a year is ``lax.scan`` over the 730-entry forcing
pytree (no dynamic gathers); monthly means accumulate in the scan carry
(see run_year_scenario) instead of the reference's per-step
accumulate-and-flush (src/greb.f90:962-987).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass
from ..config import Experiment, Numerics, PhysicsParams
from ..forcing import ClimForcing, Corrections, Derived, ModelState
from ..grid import Grid, month_average_matrix
from ..ops import fastcirc as fc
from ..ops import fastcirc2 as fc2
from ..ops import pointwise as pw
from ..ops import stencils as stc

F32 = np.float32


# ---------------------------------------------------------------------------
# Per-step forcing slices (the xs of the year scan)
# ---------------------------------------------------------------------------
@pytree_dataclass
class StepForcing:
    tclim: jax.Array    # (t,y,x)
    qclim: jax.Array
    swet: jax.Array
    u: jax.Array
    v: jax.Array
    mld: jax.Array
    mld_prev: jax.Array  # mld at ityr-1 (wrapped; src/greb.f90:507-508)
    cld: jax.Array
    sw_solar: jax.Array  # (t,y)


def step_forcing_from_clim(f: ClimForcing) -> StepForcing:
    return StepForcing(
        tclim=f.tclim, qclim=f.qclim, swet=f.swetclim, u=f.uclim, v=f.vclim,
        mld=f.mldclim, mld_prev=jnp.roll(f.mldclim, 1, axis=0),
        cld=f.cldclim, sw_solar=f.sw_solar,
    )


class StepOutputs(NamedTuple):
    """Per-step fields accumulated into monthly/annual means."""
    ts: jax.Array
    ta: jax.Array
    to: jax.Array
    q: jax.Array
    albedo: jax.Array
    # annual console diagnostics extras (src/greb.f90:944-947)
    sw: jax.Array
    lw_surf: jax.Array
    q_lat: jax.Array
    q_sens: jax.Array


class Tendencies(NamedTuple):
    sw: jax.Array
    albedo: jax.Array
    lw_surf: jax.Array
    lwair_up: jax.Array
    lwair_down: jax.Array
    em: jax.Array
    q_sens: jax.Array
    q_lat: jax.Array
    q_lat_air: jax.Array
    dq_eva: jax.Array
    dq_rain: jax.Array
    dta_crcl: jax.Array
    dq_crcl: jax.Array
    dt_ocean: jax.Array
    dto: jax.Array


@pytree_dataclass
class ModelData:
    """Everything time-constant the step needs (device arrays)."""
    params: PhysicsParams
    derived: Derived
    z_topo: jax.Array
    glacier: jax.Array
    sf: stc.StencilFields


def compute_tendencies(state: ModelState, fx, co2, md: ModelData,
                       st: stc.StencilStatic, num: Numerics, exp: Experiment,
                       extend: stc.Extend = stc.extend_lat_zero,
                       unroll_circ: bool = False,
                       fastcirc=None) -> Tendencies:
    """Reference: tendencies, src/greb.f90:277-308.

    ``fastcirc`` is an optional ``(FastPlan, FastConst)`` pair; when given
    (and no legacy transport override is active) the circulation uses the
    coefficient-folded fast path (ops/fastcirc.py), assembling the step's
    coefficients on device from the constants and this step's winds."""
    p, d = md.params, md.derived
    swr = pw.shortwave(state.ts, fx.cld, fx.sw_solar, md.z_topo, md.glacier, p, exp)
    lwr = pw.longwave(state.ts, state.ta, state.q, co2, fx.cld, fx.tclim,
                      fx.qclim, md.z_topo, d.wz_air, p, exp)
    q_sens = pw.sensible_heat(state.ts, state.ta, p)
    hyd = pw.hydrology(state.ts, state.q, fx.u, fx.v, fx.swet, md.z_topo,
                       d.wz_air, p, exp)

    # wind sign splits (src/greb.f90:203-216), computed on the fly
    u_m = jnp.maximum(fx.u, 0.0)
    u_p = jnp.minimum(fx.u, 0.0)
    v_m = jnp.maximum(fx.v, 0.0)
    v_p = jnp.minimum(fx.v, 0.0)
    nsub = num.nsub_crcl

    circ = functools.partial(stc.circulation, u_m=u_m, u_p=u_p, v_m=v_m,
                             v_p=v_p, st=st, sf=md.sf, kappa=p.kappa,
                             nsub=nsub, extend=extend, unroll=unroll_circ)
    zero = jnp.zeros_like(state.ta)
    if exp.circulation_off:                      # legacy log_exp <= 4
        dta_crcl, dq_crcl = zero, zero
    elif exp.vapor_circulation_off:              # legacy log_exp 7, 16
        dta_crcl = circ(state.ta, d.wz_air)
        dq_crcl = zero
    elif exp.vapor_diffusion_only:               # legacy log_exp 8
        dta_crcl = circ(state.ta, d.wz_air)
        dq_crcl = circ(state.q, d.wz_vapor, include_advection=False)
    elif fastcirc is not None:
        # coefficient-folded fast path (batched Ta, q along the F axis);
        # the const pytree's type selects the v1 (banded) or v2 (uniform
        # masked) fold — see ops/fastcirc.py and ops/fastcirc2.py.  A third
        # tuple element (MxuConst) switches the zonal applies to the
        # matmul formulation for large member batches.
        plan, const = fastcirc[0], fastcirc[1]
        mxu = fastcirc[2] if len(fastcirc) > 2 else None
        x2 = jnp.stack([state.ta, state.q], axis=-3)
        if isinstance(const, fc2.Fast2ShardConst):
            # latitude-sharded fold: runs on the LOCAL slab inside
            # shard_map; ``extend`` is the ppermute halo exchange
            cf_t = fc2.step_coeffs(fx.u, fx.v, const, plan)
            dx2 = fc2.sharded_circulation(x2, cf_t, const, plan, nsub,
                                          extend, unroll=unroll_circ)
        elif mxu is not None:
            cf_t = fc2.step_coeffs(fx.u, fx.v, const, plan)
            dx2 = fc2.mxu_circulation(x2, cf_t, const, mxu, plan, nsub,
                                      unroll=unroll_circ)
        elif isinstance(const, fc2.Fast2Const):
            cf_t = fc2.step_coeffs(fx.u, fx.v, const, plan)
            dx2 = fc2.circulation(x2, cf_t, const, plan, nsub,
                                  unroll=unroll_circ)
        else:
            cf_t = fc.step_coeffs(fx.u, fx.v, const, plan)
            dx2 = fc.circulation(x2, cf_t, const, plan, nsub,
                                 unroll=unroll_circ)
        dta_crcl = dx2[..., 0, :, :]
        dq_crcl = dx2[..., 1, :, :]
    else:
        # batch (Ta, q) along a leading axis: one fused circulation
        x2 = jnp.stack([state.ta, state.q], axis=-3)
        wz2 = jnp.stack([d.wz_air, d.wz_vapor], axis=-3)
        dx2 = circ(x2, wz2)
        dta_crcl = dx2[..., 0, :, :]
        dq_crcl = dx2[..., 1, :, :]

    doc = pw.deep_ocean(state.ts, state.to, fx.mld, fx.mld_prev, md.z_topo,
                        F32(num.dt), d, p, exp)
    return Tendencies(sw=swr.sw, albedo=swr.albedo, lw_surf=lwr.lw_surf,
                      lwair_up=lwr.lwair_up, lwair_down=lwr.lwair_down,
                      em=lwr.em, q_sens=q_sens, q_lat=hyd.q_lat,
                      q_lat_air=hyd.q_lat_air, dq_eva=hyd.dq_eva,
                      dq_rain=hyd.dq_rain, dta_crcl=dta_crcl,
                      dq_crcl=dq_crcl, dt_ocean=doc.dt_ocean, dto=doc.dto)


# ---------------------------------------------------------------------------
# Scenario step (reference: time_loop, src/greb.f90:239-274)
# ---------------------------------------------------------------------------
def scenario_step(state: ModelState, fx: StepForcing, corr_t, co2,
                  md: ModelData, st: stc.StencilStatic, num: Numerics,
                  exp: Experiment, extend: stc.Extend = stc.extend_lat_zero,
                  unroll_circ: bool = False,
                  fastcirc=None) -> Tuple[ModelState, StepOutputs]:
    if exp.sst_plus_one:  # legacy exp 14-16 (greb.original.model.f90:225-226)
        state = state.replace(ts=jnp.where(md.z_topo < 0.0, fx.tclim + 1.0,
                                           state.ts))
    ten = compute_tendencies(state, fx, co2, md, st, num, exp, extend,
                             unroll_circ, fastcirc)
    tf_t, tof_t, qf_t = corr_t
    dt = F32(num.dt)

    ts0 = state.ts + ten.dt_ocean + dt * (
        ten.sw + ten.lw_surf - ten.lwair_down + ten.q_lat + ten.q_sens
        + tf_t) / state.cap_surf
    ta0 = state.ta + ten.dta_crcl + dt * (
        ten.lwair_up + ten.lwair_down - ten.em * ten.lw_surf + ten.q_lat_air
        - ten.q_sens) / md.derived.cap_air
    to0 = state.to + ten.dto + tof_t
    dq = dt * (ten.dq_eva + ten.dq_rain) + ten.dq_crcl + qf_t
    dq = jnp.where(dq <= -state.q, -0.9 * state.q, dq)  # positivity (:265)
    q0 = state.q + dq
    cap = pw.seaice_capacity(ts0, state.cap_surf, fx.mld, md.z_topo,
                             md.glacier, md.derived, md.params, exp)
    new_state = ModelState(ts=ts0, ta=ta0, to=to0, q=q0, cap_surf=cap)
    out = StepOutputs(ts=ts0, ta=ta0, to=to0, q=q0, albedo=ten.albedo,
                      sw=ten.sw, lw_surf=ten.lw_surf, q_lat=ten.q_lat,
                      q_sens=ten.q_sens)
    return new_state, out


# ---------------------------------------------------------------------------
# Flux-correction step (reference: qflux_correction, src/greb.f90:311-364)
# ---------------------------------------------------------------------------
def fluxcorr_step(state: ModelState, fx: StepForcing, co2,
                  md: ModelData, st: stc.StencilStatic, num: Numerics,
                  exp: Experiment, extend: stc.Extend = stc.extend_lat_zero,
                  unroll_circ: bool = False, fastcirc=None):
    ten = compute_tendencies(state, fx, co2, md, st, num, exp, extend,
                             unroll_circ, fastcirc)
    dt = F32(num.dt)
    cap = state.cap_surf
    dts = dt * (ten.sw + ten.lw_surf - ten.lwair_down + ten.q_lat
                + ten.q_sens) / cap
    ts0_raw = state.ts + dts + ten.dt_ocean
    tf = (fx.tclim - ts0_raw) * cap / dt                   # [W/m^2] (:344-345)
    ts0 = state.ts + dts + ten.dt_ocean + tf * dt / cap

    dta = dt * (ten.lwair_up + ten.lwair_down - ten.em * ten.lw_surf
                + ten.q_lat_air - ten.q_sens) / md.derived.cap_air
    ta0 = state.ta + dta + ten.dta_crcl

    to0_raw = state.to + ten.dto
    tof = md.derived.toclim - to0_raw                      # [K/step] (:349)
    to0 = state.to + ten.dto + tof

    dq = dt * (ten.dq_eva + ten.dq_rain)
    q0_raw = state.q + dq + ten.dq_crcl
    qf = fx.qclim - q0_raw                                 # (:353)
    q0 = state.q + dq + ten.dq_crcl + qf

    cap_new = pw.seaice_capacity(ts0, cap, fx.mld, md.z_topo, md.glacier,
                                 md.derived, md.params, exp)
    new_state = ModelState(ts=ts0, ta=ta0, to=to0, q=q0, cap_surf=cap_new)
    return new_state, (tf, tof, qf)


# ---------------------------------------------------------------------------
# Year-granular phase runners
# ---------------------------------------------------------------------------
class YearDiag(NamedTuple):
    """Annual console diagnostics (src/greb.f90:948-957)."""
    global_mean_ts: jax.Array  # scalar [K]
    point_ts: jax.Array        # Tsurf at (ipx, ipy) [K]
    mean_fields: StepOutputs   # annual means of all step outputs
    # annual means of the correction tables (the reference's ftmn/fqmn
    # accumulators, src/greb.f90:945-947; constant across scenario years
    # since the tables are learned once in spin-up). None when not attached.
    ft_mean: Optional[jax.Array] = None
    fq_mean: Optional[jax.Array] = None


def correction_annual_means(corr: Corrections):
    """Annual means of TF/qF correction tables (ftmn/fqmn,
    src/greb.f90:945-947) — scenario-phase tables repeat every year, so the
    mean over the 730 ityr slots IS the annual mean."""
    return corr.tf.mean(axis=-3), corr.qf.mean(axis=-3)


def run_year_fluxcorr(state: ModelState, sfx: StepForcing, co2, md: ModelData,
                      st: stc.StencilStatic, num: Numerics, exp: Experiment,
                      extend: stc.Extend = stc.extend_lat_zero,
                      unroll_circ: bool = False, fastcirc=None):
    """One year of the spin-up; returns the 730-slot correction tables
    (each year of the reference loop fully overwrites them, so only the
    final year's tables matter; src/greb.f90:325-362)."""
    def body(s, fx):
        return fluxcorr_step(s, fx, co2, md, st, num, exp, extend,
                             unroll_circ, fastcirc)

    state, (tf, tof, qf) = jax.lax.scan(body, state, sfx)
    return state, Corrections(tf=tf, tof=tof, qf=qf)


def run_year_scenario(state: ModelState, sfx: StepForcing, corr: Corrections,
                      co2, md: ModelData, st: stc.StencilStatic, num: Numerics,
                      exp: Experiment, month_mat: jax.Array,
                      extend: stc.Extend = stc.extend_lat_zero,
                      unroll_circ: bool = False,
                      with_outputs: bool = True,
                      fastcirc=None):
    """One scenario year.

    Returns (state, monthly(12,5,y,x), annual-mean StepOutputs).

    Monthly/annual means are accumulated IN the scan carry (one
    dynamic-update of the current month slot per step) rather than stacking
    all per-step outputs and contracting afterwards: the stacked form costs
    O(nstep*9*y*x) HBM per member — 14.6 GB for a 128-member ensemble —
    and its write traffic, not compute, dominated the vmapped path.
    Global reductions (console diagnostics) are done by ``year_diag``
    OUTSIDE this function so the same trace works shard-locally under
    shard_map."""
    nmon = month_mat.shape[0]
    m_idx = jnp.argmax(month_mat, axis=0).astype(jnp.int32)     # (t,)
    m_w = jnp.take_along_axis(month_mat, m_idx[None, :], axis=0)[0]  # (t,)

    def body(carry, xs):
        s, monthly, sums = carry
        fx, corr_t, mi, mw = xs
        s2, out = scenario_step(s, fx, corr_t, co2, md, st, num, exp, extend,
                                unroll_circ, fastcirc)
        if with_outputs:
            f5 = jnp.stack([out.ts, out.ta, out.to, out.q, out.albedo],
                           axis=-3)
            slot = jax.lax.dynamic_slice_in_dim(monthly, mi, 1, axis=-4)
            monthly = jax.lax.dynamic_update_slice_in_dim(
                monthly, slot + mw * f5[..., None, :, :, :], mi, axis=-4)
            sums = jax.tree.map(lambda a, b: a + b, sums, out)
        return (s2, monthly, sums), None

    y, x = state.ts.shape[-2:]
    batch = state.ts.shape[:-2]
    monthly0 = jnp.zeros(batch + (nmon, 5, y, x), jnp.float32)
    zero = jnp.zeros(batch + (y, x), jnp.float32)
    sums0 = StepOutputs(*([zero] * len(StepOutputs._fields)))

    (state, monthly, sums), _ = jax.lax.scan(
        body, (state, monthly0, sums0),
        (sfx, (corr.tf, corr.tof, corr.qf), m_idx, m_w))

    if not with_outputs:
        return state, None, None
    mean_fields = jax.tree.map(
        lambda a: a / jnp.float32(num.nstep_yr), sums)
    return state, monthly, mean_fields


def year_diag(mean_fields: StepOutputs, num: Numerics) -> YearDiag:
    """Console diagnostics from full (unsharded) annual-mean fields
    (reference src/greb.f90:948-957; unweighted global mean)."""
    gm = jnp.mean(mean_fields.ts, axis=(-2, -1))
    pt = mean_fields.ts[..., num.ipy - 1, num.ipx - 1]
    return YearDiag(global_mean_ts=gm, point_ts=pt, mean_fields=mean_fields)


def co2_series_for_run(num: Numerics, exp: Experiment,
                       co2_ppm_series: np.ndarray) -> np.ndarray:
    """Per-year CO2 for the scenario phase.

    Modern variant: namelist series lookup (src/greb.f90:918-926).
    Legacy variant: constant 680 or the A1B ramp for log_exp 12/13
    (src/greb.original.model.f90:939-953)."""
    years = num.year0 + np.arange(num.time_scnr)
    if not exp.active:
        return np.asarray(co2_ppm_series, F32)[: num.time_scnr]
    if exp.sst_plus_one:
        return np.full(num.time_scnr, exp.co2_ctrl, F32)
    if exp.a1b_co2:
        co2 = np.full(num.time_scnr, 680.0, F32)
        y = years.astype(F32)
        co2 = np.where(y <= 2000, F32(310.0) + F32(60.0 / 50.0) * (y - 1950), co2)
        co2 = np.where((y > 2000) & (y <= 2050),
                       F32(370.0) + F32(150.0 / 50.0) * (y - 2000), co2)
        co2 = np.where((y > 2050) & (y <= 2100),
                       F32(520.0) + F32(180.0 / 50.0) * (y - 2050), co2)
        return co2.astype(F32)
    return np.full(num.time_scnr, 680.0, F32)
