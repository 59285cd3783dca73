"""Pointwise (per-gridpoint) physics operators.

Pure float32 functions of (state slices, forcing slices, params); no module
state, no in-place mutation.  Each op documents the reference subroutine it
reproduces.  All ops broadcast over arbitrary leading batch axes (vmap
ensembles, stacked fields).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import Experiment, PhysicsParams
from ..forcing import Derived


class SWResult(NamedTuple):
    sw: jax.Array
    albedo: jax.Array


def shortwave(ts, cld_t, sw_solar_t, z_topo, glacier,
              p: PhysicsParams, exp: Experiment = Experiment()) -> SWResult:
    """SW radiation with temperature-dependent ice/snow albedo.
    Reference: SWradiation, src/greb.f90:367-403.

    sw_solar_t: (..., y) per-latitude 24h-mean insolation at this step.
    """
    a_atmos = cld_t * p.a_cloud
    land = z_topo >= 0.0

    def ramp(t1, t2):
        r = p.a_no_ice + p.da_ice * (1.0 - (ts - t1) / (t2 - t1))
        return jnp.where(ts <= t1, p.a_no_ice + p.da_ice,
                         jnp.where(ts >= t2, p.a_no_ice, r))

    a_surf = jnp.where(land, ramp(p.Tl_ice1, p.Tl_ice2),
                       ramp(p.To_ice1, p.To_ice2))
    a_surf = jnp.where(glacier > 0.5, p.a_no_ice + p.da_ice, a_surf)
    if exp.fixed_albedo:  # legacy log_exp <= 5 (greb.original.model.f90:394)
        a_surf = jnp.full_like(a_surf, p.a_no_ice)
    albedo = a_surf + a_atmos - a_surf * a_atmos
    sw = sw_solar_t[..., :, None] * (1.0 - albedo)
    return SWResult(sw=sw, albedo=albedo)


class LWResult(NamedTuple):
    lw_surf: jax.Array
    lwair_up: jax.Array
    lwair_down: jax.Array
    em: jax.Array


def longwave(ts, ta, q, co2, cld_t, tclim_t, qclim_t, z_topo, wz_air,
             p: PhysicsParams, exp: Experiment = Experiment()) -> LWResult:
    """Empirical log-law greenhouse scheme.
    Reference: LWradiation, src/greb.f90:407-434.  dTrad = -0.16*Tclim - 5
    (src/greb.f90:176) is folded in here from the climatology slice."""
    pe = p.p_emi
    e_co2 = wz_air * co2
    e_vapor = wz_air * p.r_qviwv * q
    if exp.linear_vapor_lw:  # legacy log_exp == 11 (:423)
        e_vapor = wz_air * p.r_qviwv * qclim_t
    e_cloud = cld_t
    em = (pe[3] * jnp.log(pe[0] * e_co2 + pe[1] * e_vapor + pe[2]) + pe[6]
          + pe[4] * jnp.log(pe[0] * e_co2 + pe[2])
          + pe[5] * jnp.log(pe[1] * e_vapor + pe[2]))
    em = (pe[7] - e_cloud) / pe[8] * (em - pe[9]) + pe[9]
    if exp.linear_vapor_lw:  # legacy log_exp == 11 (:430)
        em = em + 0.022 / (0.15 * 24.0) * p.r_qviwv * (q - qclim_t)

    dtrad_t = -0.16 * tclim_t - 5.0
    lw_surf = -p.sig * ts ** 4
    lwair_down = -em * p.sig * (ta + dtrad_t) ** 4
    return LWResult(lw_surf=lw_surf, lwair_up=lwair_down,
                    lwair_down=lwair_down, em=em)


def sensible_heat(ts, ta, p: PhysicsParams) -> jax.Array:
    """Q_sens = ct_sens*(Ta - Ts).  Reference: src/greb.f90:295."""
    return p.ct_sens * (ta - ts)


class HydroResult(NamedTuple):
    q_lat: jax.Array
    q_lat_air: jax.Array
    dq_eva: jax.Array
    dq_rain: jax.Array


def hydrology(ts, q, u_t, v_t, swet_t, z_topo, wz_air,
              p: PhysicsParams, exp: Experiment = Experiment()) -> HydroResult:
    """Bulk hydrological cycle (evaporation / rain / latent heat).
    Reference: hydro, src/greb.f90:438-469."""
    zero = jnp.zeros_like(ts)
    if exp.hydro_off:  # legacy log_exp <= 6, 13, 15 (:453)
        return HydroResult(zero, zero, zero, zero)
    abswind = jnp.sqrt(u_t * u_t + v_t * v_t)
    abswind = jnp.where(z_topo > 0.0, jnp.sqrt(abswind ** 2 + 4.0), abswind)
    abswind = jnp.where(z_topo < 0.0, jnp.sqrt(abswind ** 2 + 9.0), abswind)
    # Magnus-type saturation humidity, topo-scaled (:457-458)
    tc = ts - 273.15
    qs = 3.75e-3 * jnp.exp(17.08085 * tc / (tc + 234.175))
    qs = qs * wz_air
    q_lat = (q - qs) * abswind * p.cq_latent * p.rho_air * p.ce * swet_t
    dq_eva = -q_lat / p.cq_latent / p.r_qviwv
    dq_rain = p.cq_rain * q
    q_lat_air = -dq_rain * p.cq_latent * p.r_qviwv
    return HydroResult(q_lat=q_lat, q_lat_air=q_lat_air,
                       dq_eva=dq_eva, dq_rain=dq_rain)


def seaice_capacity(ts, cap_surf_prev, mld_t, z_topo, glacier,
                    d: Derived, p: PhysicsParams,
                    exp: Experiment = Experiment()) -> jax.Array:
    """State-dependent surface heat capacity (sea-ice proxy).
    Reference: seaice, src/greb.f90:472-492.  Land points keep their
    previous value (the Fortran `where` never touches them)."""
    cap_open = d.cap_ocean * mld_t
    if exp.simple_seaice:  # legacy log_exp <= 5 (greb.original.model.f90:492-496)
        cap = jnp.where(z_topo > 0.0, d.cap_land, cap_open)
        # note: z_topo == 0 keeps previous (matches reference where-pair)
        cap = jnp.where(z_topo == 0.0, cap_surf_prev, cap)
    else:
        ramp = d.cap_land + (cap_open - d.cap_land) / (p.To_ice2 - p.To_ice1) * (ts - p.To_ice1)
        cap_ocean_pts = jnp.where(ts <= p.To_ice1, d.cap_land,
                                  jnp.where(ts >= p.To_ice2, cap_open, ramp))
        cap = jnp.where(z_topo < 0.0, cap_ocean_pts, cap_surf_prev)
    return jnp.where(glacier > 0.5, d.cap_land, cap)


class DeepOceanResult(NamedTuple):
    dt_ocean: jax.Array  # surface-layer increment [K]
    dto: jax.Array       # deep-layer increment [K]


def deep_ocean(ts, to, mld_t, mld_tm1, z_topo, dt, d: Derived,
               p: PhysicsParams, exp: Experiment = Experiment()) -> DeepOceanResult:
    """Two-layer deep-ocean heat uptake.
    Reference: deep_ocean, src/greb.f90:495-525.  Entrainment/detrainment is
    ocean-masked; the turbulent-exchange terms are applied unconditionally,
    exactly as the reference does (incl. over land)."""
    zero = jnp.zeros_like(ts)
    if exp.deep_ocean_off:  # legacy :514-515
        return DeepOceanResult(zero, zero)
    dmld = mld_t - mld_tm1
    ocean_warm = (z_topo < 0.0) & (ts >= p.To_ice2)
    depth_below = d.z_ocean - mld_t
    safe_below = jnp.where(depth_below != 0.0, depth_below, 1.0)
    safe_mld = jnp.where(mld_t != 0.0, mld_t, 1.0)

    dto = jnp.where(ocean_warm & (dmld < 0.0),
                    -dmld / safe_below * (ts - to), zero)
    dt_ocean = jnp.where(ocean_warm & (dmld > 0.0),
                         dmld / safe_mld * (to - ts), zero)
    dto = p.c_effmix * dto
    dt_ocean = p.c_effmix * dt_ocean

    tx = jnp.maximum(p.To_ice2, ts)
    dto = dto + dt * p.co_turb * (tx - to) / (d.cap_ocean * safe_below)
    dt_ocean = dt_ocean + dt * p.co_turb * (to - tx) / (d.cap_ocean * safe_mld)
    return DeepOceanResult(dt_ocean=dt_ocean, dto=dto)
