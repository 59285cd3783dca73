"""vmapped physics-perturbed ensembles.

The reference supports ensembles only as separate processes writing
``output_file_ens-id`` files (src/greb.f90:153,1064-1068).  Here an
ensemble is ``jax.vmap`` of the whole year-runner over a stacked
PhysicsParams pytree (every "constant" is a traced leaf) + stacked state and
correction tables.  Forcing and grid constants stay unbatched (broadcast).

Note: parameters that define the static polar sub-cycling schedule (kappa,
pi — see grid.make_grid) keep the BASE member's schedule for all members;
the coefficients themselves follow each member's values.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PhysicsParams
from ..forcing import ClimForcing, Corrections, build_derived, initial_state
from ..model import core

F32 = np.float32


def stack_params(members: Sequence[PhysicsParams]) -> PhysicsParams:
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                        *members)


def perturbed_params(base: PhysicsParams, perturb: Dict[str, np.ndarray]
                     ) -> PhysicsParams:
    """Batch ``base`` with per-member values for the keys in ``perturb``
    (each an (n_members,) array); other leaves are broadcast-stacked."""
    n = len(next(iter(perturb.values())))
    members = []
    for i in range(n):
        members.append(base.replace(**{k: np.float32(v[i])
                                       for k, v in perturb.items()}))
    return stack_params(members)


def ensemble_data(params_batched: PhysicsParams, forcing: ClimForcing,
                  sf) -> core.ModelData:
    """Per-member derived constants via vmap(build_derived)."""
    derived = jax.vmap(lambda p: build_derived(p, forcing))(params_batched)
    return core.ModelData(params=params_batched, derived=derived,
                          z_topo=forcing.z_topo, glacier=forcing.glacier,
                          sf=sf)


_MD_AXES = core.ModelData(params=0, derived=0, z_topo=None, glacier=None,
                          sf=None)


def ensemble_initial_state(params_batched: PhysicsParams,
                           forcing: ClimForcing, md: core.ModelData):
    return jax.vmap(lambda p, d: initial_state(p, forcing, d))(
        params_batched, md.derived)


# Params whose perturbation changes the circulation OPERATOR itself — the
# shared fast-circulation coefficient tables are invalid if any of these
# varies across members (kappa scales the stencils; z_air/z_vapor set the
# wz topography weights baked into the coefficients; pi sets grid metrics).
TRANSPORT_PARAM_KEYS = frozenset({"kappa", "z_air", "z_vapor", "pi"})


def fastcirc_shareable(perturb_keys) -> bool:
    """True if one fast-circulation coefficient table can serve all members
    perturbed over ``perturb_keys``."""
    return not (set(perturb_keys) & TRANSPORT_PARAM_KEYS)


def _bcastable(a, ndim_extra: int = 2):
    """(M,) leaf -> (M, 1, 1) so it broadcasts against (M, y, x) fields in
    the BATCHED (non-vmap) ensemble runners."""
    a = jnp.asarray(a)
    return a.reshape(a.shape + (1,) * ndim_extra) if a.ndim == 1 else a


def batched_model_data(params_b: PhysicsParams, forcing: ClimForcing,
                       sf) -> core.ModelData:
    """ModelData whose per-member leaves broadcast WITHOUT vmap: scalar
    params/derived become (M, 1, 1); p_emi becomes a tuple of 10 (M, 1, 1)
    leaves (indexed p_emi[i] in the physics ops)."""
    md = ensemble_data(params_b, forcing, sf)
    pe = jnp.asarray(params_b.p_emi)               # (M, 10)
    pkw = {f: _bcastable(getattr(params_b, f))
           for f in PhysicsParams.__dataclass_fields__ if f != "p_emi"}
    params = PhysicsParams(p_emi=tuple(pe[:, i].reshape(-1, 1, 1)
                                       for i in range(10)), **pkw)
    d = md.derived
    derived = d.replace(cap_ocean=_bcastable(d.cap_ocean),
                        cap_land=_bcastable(d.cap_land),
                        cap_air=_bcastable(d.cap_air))
    return core.ModelData(params=params, derived=derived, z_topo=md.z_topo,
                          glacier=md.glacier, sf=md.sf)


def make_batched_ensemble_runners(st, num, exp, month_mat, extend=None,
                                  unroll_circ: bool = False, fast_plan=None):
    """Batched (leading-member-axis, no vmap) ensemble runners.

    Unlike the vmapped runners, the member axis stays a REAL array axis all
    the way into the circulation, so the zonal applies can run as
    (M, X) @ (X, X) batched matmuls (fastcirc2.mxu_circulation).
    Corrections travel time-major ((t, M, y, x)) to serve as scan xs.

    ``fcdata = (Fast2Const,)`` uses the elementwise fold; ``fcdata =
    (Fast2Const, MxuConst)`` (from fastcirc2.build_mxu) selects the matmul
    formulation.
    Per-member params must come from ``batched_model_data`` so scalar
    leaves broadcast as (M, 1, 1).

    fluxcorr_year(state_B, sfx, co2, md_B, fcdata) -> (state_B, corr_tM)
    scenario_year(state_B, sfx, corr_tM, co2, md_B, fcdata)
        -> (state_B, monthly (M, nmon, 5, y, x), mean_fields_B)
    """
    from ..ops import stencils as stc
    extend = extend or stc.extend_lat_zero

    def _fcirc(fcdata):
        if fcdata is None:
            return None
        return (fast_plan,) + tuple(fcdata)

    def flux_year(state, sfx, co2, md, fcdata=None):
        return core.run_year_fluxcorr(state, sfx, co2, md, st, num, exp,
                                      extend, unroll_circ,
                                      fastcirc=_fcirc(fcdata))

    def scnr_year(state, sfx, corr, co2, md, fcdata=None):
        return core.run_year_scenario(state, sfx, corr, co2, md, st, num,
                                      exp, month_mat, extend, unroll_circ,
                                      fastcirc=_fcirc(fcdata))

    return jax.jit(flux_year), jax.jit(scnr_year)


def make_ensemble_runners(st, num, exp, month_mat, extend=None,
                          unroll_circ: bool = False, fast_plan=None):
    """Returns jitted (fluxcorr_year, scenario_year) vmapped over members.

    fluxcorr_year(state_B, sfx, co2_scalar, md_B, fcdata=None)
        -> (state_B, corr_B)
    scenario_year(state_B, sfx, corr_B, co2_scalar, md_B, fcdata=None)
        -> (state_B, monthly_B, mean_fields_B)

    ``fcdata = (FastConst,)`` (with the matching static ``fast_plan``)
    enables the coefficient-folded circulation SHARED across members — only
    valid when no transport parameter is perturbed (fastcirc_shareable);
    constants are broadcast, never batched."""
    from ..ops import stencils as stc
    extend = extend or stc.extend_lat_zero

    def _fcirc(fcdata):
        return ((fast_plan,) + tuple(fcdata)) if fcdata is not None else None

    def flux_one(state, sfx, co2, md, fcdata):
        return core.run_year_fluxcorr(state, sfx, co2, md, st, num, exp,
                                      extend, unroll_circ,
                                      fastcirc=_fcirc(fcdata))

    def scnr_one(state, sfx, corr, co2, md, fcdata):
        return core.run_year_scenario(state, sfx, corr, co2, md, st, num,
                                      exp, month_mat, extend, unroll_circ,
                                      fastcirc=_fcirc(fcdata))

    flux_v = jax.jit(jax.vmap(flux_one,
                              in_axes=(0, None, None, _MD_AXES, None)))
    scnr_v = jax.jit(jax.vmap(scnr_one,
                              in_axes=(0, None, 0, None, _MD_AXES, None)))

    def flux_call(state, sfx, co2, md, fcdata=None):
        return flux_v(state, sfx, co2, md, fcdata)

    def scnr_call(state, sfx, corr, co2, md, fcdata=None):
        return scnr_v(state, sfx, corr, co2, md, fcdata)

    return flux_call, scnr_call
