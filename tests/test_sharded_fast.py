"""Coefficient-folded circulation under latitude sharding
(fastcirc2.build_sharded / sharded_circulation) vs the unsharded fold.

Runs on the 8-virtual-CPU-device mesh (tests/conftest).  The sharded plan
covers every extra-iteration row with per-shard composite operators
(identity-flagged padding on shards that own none) and iterates the
wind-dependent advection sub-cycles with per-level masked slabs — one SPMD
program for all shards, halo exchange via ppermute (parallel.halo).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from greb_tpu.config import GrebConfig, Numerics
from greb_tpu.forcing import Corrections, forcing_from_arrays
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model.driver import GREB
from greb_tpu.ops import fastcirc2 as fc2
from greb_tpu.parallel.sharded import (make_emulated_year_runners, make_mesh,
                                       make_sharded_year_runners,
                                       shard_fastcirc, shard_inputs)

CO2 = jnp.float32(680.0)


def _model(num):
    if (num.xdim, num.ydim) != (96, 48):
        arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
        from greb_tpu.regrid import regrid_forcing_arrays
        forcing = forcing_from_arrays(regrid_forcing_arrays(arrs, num))
    else:
        forcing = forcing_from_arrays(
            make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr))
    return GREB(GrebConfig(numerics=num, fast_circulation=True),
                forcing=forcing, verbose=False)


def _run_pair(num, n_y, **build_kw):
    m = _model(num)
    plan, fcdata = m._fastcirc_split()
    state0 = m.initial_state()
    fl, sc = m._year_fluxcorr(), m._year_scenario()
    s_ref, corr_ref = fl(state0, m.sfx, CO2, m.md, fcdata)
    s_ref2, mon_ref, _ = sc(s_ref, m.sfx, corr_ref, CO2, m.md, fcdata)

    mesh = make_mesh(n_ens=1, n_y=n_y)
    splan, sconst = fc2.build_sharded(
        np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
        m.grid, m.st, kappa=float(m.params.kappa), n_shards=n_y, **build_kw)
    sconst_sh = shard_fastcirc(mesh, sconst)
    flux_sh, scnr_sh = make_sharded_year_runners(mesh, m.st, num, m.exp,
                                                 m.month_mat,
                                                 fast_plan=splan)
    corr0 = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    state_s, sfx_s, _, md_s = shard_inputs(mesh, False, state0, m.sfx,
                                           corr0, m.md)
    s_sh, corr_sh = flux_sh(state_s, sfx_s, CO2, md_s, sconst_sh)
    s_sh2, mon_sh, _ = scnr_sh(s_sh, sfx_s, corr_sh, CO2, md_s, sconst_sh)
    return splan, (s_ref, corr_ref, s_ref2, mon_ref), \
        (s_sh, corr_sh, s_sh2, mon_sh)


def test_sharded_fast_96x48():
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    splan, ref, sh = _run_pair(num, n_y=4)
    assert splan.comp_mode == "dense" and splan.kct >= 1
    (s_ref, corr_ref, s_ref2, mon_ref) = ref
    (s_sh, corr_sh, s_sh2, mon_sh) = sh
    # flux correction pins ts exactly in both
    np.testing.assert_array_equal(np.asarray(s_sh.ts), np.asarray(s_ref.ts))
    np.testing.assert_allclose(np.asarray(corr_sh.tf),
                               np.asarray(corr_ref.tf), rtol=0, atol=1.0)
    np.testing.assert_allclose(np.asarray(mon_sh), np.asarray(mon_ref),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(np.asarray(s_sh2.ts), np.asarray(s_ref2.ts),
                               rtol=0, atol=2e-2)


def test_sharded_emulated_on_one_device_bitexact():
    """make_emulated_year_runners runs the 4-shard program on one device
    with the halo exchange done by indexing: on the CPU it reproduces the
    4-device mesh bit for bit, flux correction and scenario year."""
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    m = _model(num)
    splan, ref, sh = _run_pair(num, n_y=4)
    _, sconst = fc2.build_sharded(
        np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
        m.grid, m.st, kappa=float(m.params.kappa), n_shards=4)
    flux_e, scnr_e = make_emulated_year_runners(4, m.st, num, m.exp,
                                                m.month_mat, fast_plan=splan)
    s_e, corr_e = flux_e(m.initial_state(), m.sfx, CO2, m.md, sconst)
    s_e2, mon_e, _ = scnr_e(s_e, m.sfx, corr_e, CO2, m.md, sconst)
    assert s_e2.ts.devices() == {jax.devices()[0]}
    (s_sh, corr_sh, s_sh2, mon_sh) = sh
    np.testing.assert_array_equal(np.asarray(corr_e.tf),
                                  np.asarray(corr_sh.tf))
    np.testing.assert_array_equal(np.asarray(mon_e), np.asarray(mon_sh))
    np.testing.assert_array_equal(np.asarray(s_e2.ts), np.asarray(s_sh2.ts))


def test_sharded_fast_lowrank_96x48():
    """Force the SVD-truncated composite path (dense fits any realistic
    budget at 96x48, so it needs an explicit 0 budget to engage)."""
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    splan, ref, sh = _run_pair(num, n_y=4, comp_dense_max_bytes=0)
    assert splan.comp_mode == "lowrank"
    (s_ref, corr_ref, s_ref2, mon_ref) = ref
    (s_sh, corr_sh, s_sh2, mon_sh) = sh
    np.testing.assert_array_equal(np.asarray(s_sh.ts), np.asarray(s_ref.ts))
    np.testing.assert_allclose(np.asarray(mon_sh), np.asarray(mon_ref),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(np.asarray(s_sh2.ts), np.asarray(s_ref2.ts),
                               rtol=0, atol=2e-2)


def test_sharded_fast_no_overlap_bitexact():
    """overlap_halo reorders only the ppermute issue point; the math is
    identical, so both variants must agree bit-for-bit."""
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    _, ref_a, sh_a = _run_pair(num, n_y=4, overlap_halo=True)
    _, ref_b, sh_b = _run_pair(num, n_y=4, overlap_halo=False)
    np.testing.assert_array_equal(np.asarray(sh_a[3]), np.asarray(sh_b[3]))
    np.testing.assert_array_equal(np.asarray(sh_a[2].ts),
                                  np.asarray(sh_b[2].ts))


def test_sharded_fast_refined_128x64():
    """Mixed polar bands spanning shard boundaries + masked advection
    sub-cycle levels + composites on more than one shard."""
    num = Numerics(xdim=128, ydim=64, ndays_yr=10, jday_mon=(6, 4),
                   time_flux=1, time_scnr=1)
    splan, ref, sh = _run_pair(num, n_y=8)
    assert splan.la_levels >= 1, splan     # advection levels engaged
    assert splan.kct >= 1
    (s_ref, corr_ref, s_ref2, mon_ref) = ref
    (s_sh, corr_sh, s_sh2, mon_sh) = sh
    np.testing.assert_array_equal(np.asarray(s_sh.ts), np.asarray(s_ref.ts))
    # the sharded plan composites ALL extra-iteration rows (the unsharded
    # one iterates small counts explicitly, keeping per-iteration clamps),
    # so agreement is tolerance-level, not bit-exact
    np.testing.assert_allclose(np.asarray(mon_sh), np.asarray(mon_ref),
                               rtol=0, atol=5e-2)
    np.testing.assert_allclose(np.asarray(s_sh2.ts), np.asarray(s_ref2.ts),
                               rtol=0, atol=5e-2)


def test_sharded_fast_dp_sp_members():
    """dp x sp: 2 ensemble members x 4 latitude shards with the shared
    folded tables broadcast across members."""
    from greb_tpu.parallel import ensemble as ens
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    m = _model(num)
    n_members = 2
    pb = ens.perturbed_params(
        m.params, {"ct_sens": np.float32(22.5) + 0.1 * np.arange(n_members)})
    md_b = ens.ensemble_data(pb, m.forcing, m.sf)
    state_b = ens.ensemble_initial_state(pb, m.forcing, md_b)

    # unsharded vmap reference (v2 fold)
    plan, (const,) = m._fastcirc_split()
    flux_v, scnr_v = ens.make_ensemble_runners(m.st, num, m.exp, m.month_mat,
                                               fast_plan=plan)
    s_v, corr_v = flux_v(state_b, m.sfx, CO2, md_b, (const,))
    s_v2, mon_v, _ = scnr_v(s_v, m.sfx, corr_v, CO2, md_b, (const,))

    mesh = make_mesh(n_ens=2, n_y=4)
    splan, sconst = fc2.build_sharded(
        np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
        m.grid, m.st, kappa=float(m.params.kappa), n_shards=4)
    sconst_sh = shard_fastcirc(mesh, sconst)
    flux_sh, scnr_sh = make_sharded_year_runners(mesh, m.st, num, m.exp,
                                                 m.month_mat, batched=True,
                                                 fast_plan=splan)
    corr0 = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    corr0 = jax.tree.map(
        lambda a: jnp.broadcast_to(a, (n_members,) + a.shape), corr0)
    state_s, sfx_s, _, md_s = shard_inputs(mesh, True, state_b, m.sfx,
                                           corr0, md_b)
    s_sh, corr_sh = flux_sh(state_s, sfx_s, CO2, md_s, sconst_sh)
    s_sh2, mon_sh, _ = scnr_sh(s_sh, sfx_s, corr_sh, CO2, md_s, sconst_sh)
    np.testing.assert_allclose(np.asarray(mon_sh), np.asarray(mon_v),
                               rtol=0, atol=2e-2)
    np.testing.assert_allclose(np.asarray(s_sh2.ts), np.asarray(s_v2.ts),
                               rtol=0, atol=2e-2)


def test_sharded_composites_conserve_zonal_mean():
    """The composite powers (I+C)^n of the deep polar rows (n = 1651 at the
    384x192 pole rows) map a zonally constant row onto itself: each
    operator's column sums are 1.  Built from float32-rounded coefficients
    they drifted by ~n * 1e-8, which moved the pole rows' Ta by 0.08 K per
    12-h step away from the strict stencils."""
    num = Numerics(xdim=384, ydim=192, ndays_yr=2, jday_mon=(2,),
                   time_flux=0, time_scnr=1)
    m = _model(num)
    assert int(np.asarray(m.grid.diff_sched.time2).max()) > 1000
    splan, sconst = fc2.build_sharded(
        np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
        m.grid, m.st, kappa=float(m.params.kappa), n_shards=4)
    assert splan.comp_mode == "dense"
    used = np.asarray(sconst.pid)[:, 0] == 0
    pc = np.asarray(sconst.pcomp, np.float64)[:, used]     # (F, k, X, X)
    np.testing.assert_allclose(pc.sum(axis=-2), 1.0, rtol=0, atol=1e-6)

