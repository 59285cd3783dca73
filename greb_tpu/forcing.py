"""Forcing climatologies, derived constants and model state.

The reference keeps climatologies as Fortran module arrays
(src/greb.f90:108-120) and derives a set of program constants inside
``greb_model`` (src/greb.f90:176-216).  Here they are immutable pytrees:

- ``ClimForcing``: the raw (nstep_yr, y, x) device arrays, scanned over as
  ``xs`` of a ``lax.scan`` — no per-step dynamic gathers needed.
- ``Derived``: everything derived from (params, forcing): topo weights,
  heat capacities, z_ocean, Toclim, initial state.  Built by a pure
  function of a PhysicsParams pytree, hence vmappable for ensembles with
  perturbed physics.
"""
from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ._pytree import pytree_dataclass
from .config import Experiment, Numerics, PhysicsParams

F32 = np.float32


@pytree_dataclass
class ClimForcing:
    z_topo: jax.Array     # (y,x)
    glacier: jax.Array    # (y,x)
    tclim: jax.Array      # (t,y,x)
    uclim: jax.Array
    vclim: jax.Array
    qclim: jax.Array
    mldclim: jax.Array
    swetclim: jax.Array
    cldclim: jax.Array
    sw_solar: jax.Array   # (t,y)

    @property
    def nstep_yr(self) -> int:
        return self.tclim.shape[0]


@pytree_dataclass
class Derived:
    """Derived program constants (reference src/greb.f90:176-216, 1088-1094)."""
    wz_air: jax.Array     # exp(-z_topo/z_air)
    wz_vapor: jax.Array   # exp(-z_topo/z_vapor)
    z_ocean: jax.Array    # 3 * annual max of mld
    toclim: jax.Array     # deep-ocean climatology (time-constant field)
    cap_ocean: jax.Array  # scalar: heat capacity of 1 m ocean [J/K/m^2]
    cap_land: jax.Array   # scalar
    cap_air: jax.Array    # scalar


@pytree_dataclass
class ModelState:
    """Prognostic state carried across steps (incl. the prognostic-ish
    cap_surf mutated by seaice; src/greb.f90:268,472-492)."""
    ts: jax.Array
    ta: jax.Array
    to: jax.Array
    q: jax.Array
    cap_surf: jax.Array


@pytree_dataclass
class Corrections:
    """Per-ityr flux-correction tables learned in the spin-up phase
    (src/greb.f90:344-355)."""
    tf: jax.Array   # (t,y,x)  [W/m^2]
    tof: jax.Array  # (t,y,x)  [K/step]
    qf: jax.Array   # (t,y,x)  [kg/kg/step]

    @classmethod
    def zeros(cls, nstep_yr: int, ydim: int, xdim: int) -> "Corrections":
        z = jnp.zeros((nstep_yr, ydim, xdim), jnp.float32)
        return cls(tf=z, tof=z, qf=z)


def forcing_from_arrays(arrs: Dict[str, np.ndarray]) -> ClimForcing:
    return ClimForcing(**{k: jnp.asarray(np.asarray(arrs[k], F32))
                          for k in ClimForcing.__dataclass_fields__ if k in arrs})


def load_forcing(input_dir: str, num: Numerics) -> ClimForcing:
    """Load a reference-format input directory (src/greb.f90:1018-1027,
    1073-1085)."""
    import os
    from .io.binio import read_records
    from .io.synthetic import INPUT_FILES

    y, x, t = num.ydim, num.xdim, num.nstep_yr
    arrs: Dict[str, np.ndarray] = {}
    for key, fname in INPUT_FILES.items():
        path = os.path.join(input_dir, fname)
        if key in ("z_topo", "glacier"):
            arrs[key] = read_records(path, (y, x), records=[1])[0]
        elif key == "sw_solar":
            arrs[key] = read_records(path, (t, y), records=[1])[0]
        else:
            arrs[key] = read_records(path, (y, x), count=t)
    return forcing_from_arrays(arrs)


def synthetic_forcing(num: Numerics) -> ClimForcing:
    from .io.synthetic import make_synthetic_forcing
    return forcing_from_arrays(
        make_synthetic_forcing(num.xdim, num.ydim, num.nstep_yr, num.ndays_yr))


def apply_experiment(forcing: ClimForcing, params: PhysicsParams,
                     exp: Experiment) -> ClimForcing:
    """Static field overrides of the legacy log_exp switchboard
    (src/greb.original.model.f90:162-166)."""
    if not exp.active:
        return forcing
    out = forcing
    if exp.flat_topo:
        out = out.replace(z_topo=jnp.where(out.z_topo > 1.0, 1.0, out.z_topo))
    if exp.const_cloud:
        out = out.replace(cldclim=jnp.full_like(out.cldclim, 0.7))
    if exp.const_vapor:
        out = out.replace(qclim=jnp.full_like(out.qclim, 0.0052))
    if exp.no_deep_ocean_mld:
        out = out.replace(mldclim=jnp.full_like(out.mldclim, params.d_ocean))
    return out


def build_derived(params: PhysicsParams, forcing: ClimForcing) -> Derived:
    """Pure function of (params, forcing) — vmappable over params."""
    z_topo = forcing.z_topo
    wz_air = jnp.exp(-z_topo / params.z_air)
    wz_vapor = jnp.exp(-z_topo / params.z_vapor)
    z_ocean = 3.0 * jnp.max(forcing.mldclim, axis=0)
    # Toclim: annual min of Tclim, floored at -1.7 C (src/greb.f90:1088-1094)
    toclim = jnp.min(forcing.tclim, axis=0)
    toclim = jnp.where(toclim - 273.15 < -1.7, -1.7 + 273.15, toclim)
    cap_ocean = params.cp_ocean * params.rho_ocean
    cap_land = params.cp_land * params.rho_land * params.d_land
    cap_air = params.cp_air * params.rho_air * params.d_air
    return Derived(wz_air=wz_air, wz_vapor=wz_vapor, z_ocean=z_ocean,
                   toclim=toclim, cap_ocean=cap_ocean, cap_land=cap_land,
                   cap_air=cap_air)


def initial_state(params: PhysicsParams, forcing: ClimForcing,
                  derived: Derived) -> ModelState:
    """Initial prognostic state (src/greb.f90:190-197): last climatology
    step; cap_surf from land/sea mask and first-step mld."""
    ts = forcing.tclim[-1]
    q = forcing.qclim[-1]
    to = derived.toclim  # Toclim is time-constant
    cap_surf = jnp.where(forcing.z_topo > 0.0, derived.cap_land,
                         derived.cap_ocean * forcing.mldclim[0])
    return ModelState(ts=ts, ta=ts, to=to, q=q, cap_surf=cap_surf)
