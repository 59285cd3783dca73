"""Multi-chip execution: dp (ensemble) x sp (latitude) sharding.

The reference is strictly single-process (SURVEY §2.4).  Here:

* **dp / 'ens'** — ensemble members across devices (pure data parallel, no
  collectives in the step).
* **sp / 'y'**  — latitude-domain decomposition via ``shard_map``; the only
  communication is a width-2 ``ppermute`` halo exchange per circulation
  substep (see parallel.halo) between neighbouring shards.  Longitude is kept
  shard-local on purpose: the polar CFL sub-cycles iterate along longitude
  rows and would otherwise need a halo exchange per *inner* iteration.

Everything static-per-row (coefficients, iteration masks) is carried in
``StencilFields`` arrays sharded along 'y', so one SPMD trace serves every
shard.  Global reductions (console diagnostics) happen outside on gathered
outputs.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import Experiment, Numerics
from ..forcing import Corrections, ModelState
from ..model import core
from ..ops import stencils as stc
from .halo import halo_exchange_lat_cyclic, make_sharded_extend


def make_mesh(n_ens: int = 1, n_y: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_ens * n_y
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    dev = np.asarray(devices[:n]).reshape(n_ens, n_y)
    return Mesh(dev, axis_names=("ens", "y"))


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------
def _specs(batched: bool):
    e = "ens" if batched else None

    def b(*rest):  # prepend ens axis if batched
        return P(e, *rest) if batched else P(*rest)

    state = ModelState(ts=b("y", None), ta=b("y", None), to=b("y", None),
                       q=b("y", None), cap_surf=b("y", None))
    sfx = core.StepForcing(
        tclim=P(None, "y", None), qclim=P(None, "y", None),
        swet=P(None, "y", None), u=P(None, "y", None), v=P(None, "y", None),
        mld=P(None, "y", None), mld_prev=P(None, "y", None),
        cld=P(None, "y", None), sw_solar=P(None, "y"))
    corr = Corrections(tf=b(None, "y", None), tof=b(None, "y", None),
                       qf=b(None, "y", None))

    from ..config import PhysicsParams
    from ..forcing import Derived
    pfields = {f: (b(None) if f == "p_emi" else b())
               for f in PhysicsParams.__dataclass_fields__}
    params = PhysicsParams(**pfields)
    derived = Derived(wz_air=b("y", None), wz_vapor=b("y", None),
                      z_ocean=b("y", None), toclim=b("y", None),
                      cap_ocean=b(), cap_land=b(), cap_air=b())
    sf = stc.StencilFields(
        dxlat2=P("y", None), diff_dtdff2=P("y", None),
        diff_itm=P(None, "y", None), adv_ccx2=P("y", None),
        adv_itm=P(None, "y", None), ccx_adv=P("y", None), polar=P("y", None),
        row_mfull=P("y", None), row_pfull=P("y", None))
    md = core.ModelData(params=params, derived=derived,
                        z_topo=P("y", None), glacier=P("y", None), sf=sf)
    monthly = b(None, None, "y", None)
    meanf = core.StepOutputs(*([b("y", None)] * len(core.StepOutputs._fields)))
    return state, sfx, corr, md, monthly, meanf


def _shard_map(f, mesh, in_specs, out_specs):
    try:
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    except TypeError:  # older API
        from jax.experimental.shard_map import shard_map
        return shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_rep=False)


def _fastcirc_specs():
    """PartitionSpecs for fastcirc2.Fast2ShardConst: field arrays shard
    along their Y axis; stacked composites along the per-shard-block axis."""
    from ..ops import fastcirc2 as fc2
    return fc2.Fast2ShardConst(
        zd=P(None, None, "y", None), zam=P(None, None, "y", None),
        mer=P(None, None, "y", None), wz=P(None, "y", None),
        band=P("y", None), amask=P(None, "y", None),
        pcomp=P(None, "y", None, None), pcu=P(None, "y", None, None),
        pcw=P(None, "y", None, None), pid=P("y", None))


def shard_fastcirc(mesh: Mesh, sconst):
    """device_put a Fast2ShardConst with the matching NamedShardings."""
    from jax.sharding import NamedSharding
    specs = _fastcirc_specs()
    return jax.tree.map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
        sconst, specs)


def _year_fns(st: stc.StencilStatic, num: Numerics, exp: Experiment,
              month_mat: jax.Array, batched: bool, unroll_circ: bool,
              fast_plan, extend):
    """Per-shard (fluxcorr_year, scenario_year) with ``extend`` as the halo
    exchange, and their (in_specs, out_specs) over the ('ens','y') mesh."""
    import dataclasses
    # polar band compaction indexes GLOBAL rows; under latitude sharding the
    # masked full-field form is the SPMD-uniform one
    st = dataclasses.replace(st, compact_polar=False)
    s_state, s_sfx, s_corr, s_md, s_monthly, s_meanf = _specs(batched)
    with_fc = fast_plan is not None
    s_fc = _fastcirc_specs() if with_fc else None

    def _fc(fcconst):
        return (fast_plan, fcconst) if fcconst is not None else None

    def flux_one(state, sfx, co2, md, fcconst=None):
        return core.run_year_fluxcorr(state, sfx, co2, md, st, num, exp,
                                      extend, unroll_circ,
                                      fastcirc=_fc(fcconst))

    def scnr_one(state, sfx, corr, co2, md, fcconst=None):
        return core.run_year_scenario(state, sfx, corr, co2, md, st, num,
                                      exp, month_mat, extend, unroll_circ,
                                      fastcirc=_fc(fcconst))

    if batched:
        _md_ax = core.ModelData(params=0, derived=0, z_topo=None,
                                glacier=None, sf=None)

        def flux_local(state, sfx, co2, md, fcconst=None):
            return jax.vmap(
                lambda s, m: flux_one(s, sfx, co2, m, fcconst),
                in_axes=(0, _md_ax),
            )(state, md)

        def scnr_local(state, sfx, corr, co2, md, fcconst=None):
            return jax.vmap(
                lambda s, c, m: scnr_one(s, sfx, c, co2, m, fcconst),
                in_axes=(0, 0, _md_ax),
            )(state, corr, md)
    else:
        flux_local, scnr_local = flux_one, scnr_one

    flux_in = (s_state, s_sfx, P(), s_md) + ((s_fc,) if with_fc else ())
    scnr_in = (s_state, s_sfx, s_corr, P(), s_md) + ((s_fc,) if with_fc
                                                     else ())
    return ((flux_local, flux_in, (s_state, s_corr)),
            (scnr_local, scnr_in, (s_state, s_monthly, s_meanf)))


def make_sharded_year_runners(mesh: Mesh, st: stc.StencilStatic,
                              num: Numerics, exp: Experiment,
                              month_mat: jax.Array,
                              batched: bool = False,
                              unroll_circ: bool = False,
                              fast_plan=None):
    """jitted (fluxcorr_year, scenario_year) over a ('ens','y') mesh.

    batched=True expects a leading ensemble axis on state/corr/md(params,
    derived); forcing and stencil constants are shared.

    ``fast_plan`` (a fastcirc2.ShardPlan from fastcirc2.build_sharded)
    enables the coefficient-folded circulation under latitude sharding; the
    runners then take a trailing Fast2ShardConst argument (sharded with
    shard_fastcirc).  Without it the strict masked stencils run.
    """
    extend = make_sharded_extend("y", mesh.shape["y"])
    return tuple(
        jax.jit(_shard_map(fn, mesh, in_specs=ins, out_specs=outs))
        for fn, ins, outs in _year_fns(st, num, exp, month_mat, batched,
                                       unroll_circ, fast_plan, extend))


def make_emulated_year_runners(n_y: int, st: stc.StencilStatic,
                               num: Numerics, exp: Experiment,
                               month_mat: jax.Array,
                               batched: bool = False,
                               unroll_circ: bool = False,
                               fast_plan=None):
    """The runners of ``make_sharded_year_runners`` for an ``n_y``-way
    latitude split, run on ONE device: the same per-shard program, mapped
    with ``vmap`` over the n_y latitude blocks, and the halo exchange done
    by indexing along the mapped axis (``halo_exchange_lat_cyclic``).  It
    takes and returns unsharded global arrays.  A reference for the
    cross-device exchange: against the mesh runners only the exchange
    differs."""
    extend = functools.partial(halo_exchange_lat_cyclic, axis_name="y",
                               axis_size=n_y)
    return tuple(
        jax.jit(_map_blocks(fn, n_y, ins, outs))
        for fn, ins, outs in _year_fns(st, num, exp, month_mat, batched,
                                       unroll_circ, fast_plan, extend))


def _map_blocks(fn, n: int, in_specs, out_specs):
    """``fn`` mapped over n latitude blocks of its global inputs on one
    device, as shard_map over an n-way 'y' axis would split them; axes
    without 'y' in their PartitionSpec are passed whole."""
    def y_axis(sp):
        return tuple(sp).index("y") if "y" in tuple(sp) else None

    def split(x, sp):
        i = y_axis(sp)
        if x is None or i is None:
            return x
        x = x.reshape(x.shape[:i] + (n, x.shape[i] // n) + x.shape[i + 1:])
        return jnp.moveaxis(x, i, 0)

    def merge(x, sp):
        i = y_axis(sp)
        if i is None:
            return x[0]
        x = jnp.moveaxis(x, 0, i)
        return x.reshape(x.shape[:i] + (-1,) + x.shape[i + 2:])

    is_spec = lambda x: isinstance(x, P)  # noqa: E731
    in_axes = jax.tree.map(lambda sp: None if y_axis(sp) is None else 0,
                           in_specs, is_leaf=is_spec)
    mapped = jax.vmap(fn, in_axes=in_axes, axis_name="y")

    def run(*args):
        args = jax.tree.map(split, args, in_specs,
                            is_leaf=lambda x: x is None)
        return jax.tree.map(merge, mapped(*args), out_specs)
    return run


def shard_inputs(mesh: Mesh, batched: bool, state, sfx, corr, md):
    """device_put everything with the matching NamedSharding."""
    from jax.sharding import NamedSharding
    s_state, s_sfx, s_corr, s_md, _, _ = _specs(batched)

    def put(tree, specs):
        return jax.tree.map(
            lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
            tree, specs,
            is_leaf=lambda x: x is None)

    return (put(state, s_state), put(sfx, s_sfx), put(corr, s_corr),
            put(md, s_md))
