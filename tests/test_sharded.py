"""Latitude-sharded (shard_map + ppermute halo) runners vs the unsharded
path, on the 8-virtual-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from greb_tpu.config import Experiment, GrebConfig, Numerics, PhysicsParams
from greb_tpu.forcing import Corrections, forcing_from_arrays
from greb_tpu.grid import month_average_matrix
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model.driver import GREB
from greb_tpu.parallel.sharded import (make_mesh, make_sharded_year_runners,
                                       shard_inputs)

F32 = np.float32
NUM = Numerics(xdim=32, ydim=16, ndays_yr=10, jday_mon=(6, 4),
               time_flux=1, time_scnr=1)


@pytest.fixture(scope="module")
def model():
    return GREB(GrebConfig(numerics=NUM), verbose=False)


def test_sharded_year_matches_unsharded(model, need_devices):
    need_devices(4)
    m = model
    co2f = jnp.float32(298.0)
    co2s = jnp.float32(680.0)
    mm = jnp.asarray(month_average_matrix(NUM.jday_mon, NUM.ndt_days))

    # unsharded reference
    s0 = m.initial_state()
    s_ref, corr_ref = m._year_fluxcorr()(s0, m.sfx, co2f, m.md)
    scnr = m._year_scenario(True)
    s_ref2, mon_ref, mf_ref = scnr(s_ref, m.sfx, corr_ref, co2s, m.md)

    # sharded over 4 latitude bands
    mesh = make_mesh(n_ens=1, n_y=4)
    flux_sh, scnr_sh = make_sharded_year_runners(mesh, m.st, NUM,
                                                 Experiment(), mm)
    corr0 = Corrections.zeros(NUM.nstep_yr, NUM.ydim, NUM.xdim)
    st_s, sfx_s, corr_s, md_s = shard_inputs(mesh, False, s0, m.sfx, corr0,
                                             m.md)
    s_sh, corr_sh = flux_sh(st_s, sfx_s, co2f, md_s)
    s_sh2, mon_sh, mf_sh = scnr_sh(s_sh, sfx_s, corr_sh, co2s, md_s)

    np.testing.assert_allclose(np.asarray(s_sh.ts), np.asarray(s_ref.ts),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(corr_sh.tf),
                               np.asarray(corr_ref.tf), rtol=1e-4, atol=2.0)
    np.testing.assert_allclose(np.asarray(mon_sh), np.asarray(mon_ref),
                               rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(np.asarray(s_sh2.q), np.asarray(s_ref2.q),
                               rtol=1e-4, atol=1e-7)


def test_batched_ensemble_sharding(model, need_devices):
    """dp x sp: 2 ensemble shards x 4 latitude shards, 4 members."""
    need_devices(8)
    m = model
    from greb_tpu.parallel.ensemble import (ensemble_data,
                                            ensemble_initial_state,
                                            perturbed_params)
    mesh = make_mesh(n_ens=2, n_y=4)
    mm = jnp.asarray(month_average_matrix(NUM.jday_mon, NUM.ndt_days))
    pp = perturbed_params(PhysicsParams.default(), {
        "ct_sens": np.float32(22.5) + np.linspace(-2, 2, 4, dtype=F32)})
    md = ensemble_data(pp, m.forcing, m.sf)
    state = ensemble_initial_state(pp, m.forcing, md)
    corr = Corrections.zeros(NUM.nstep_yr, NUM.ydim, NUM.xdim)
    corr = jax.tree.map(lambda a: jnp.broadcast_to(a, (4,) + a.shape), corr)

    flux_sh, scnr_sh = make_sharded_year_runners(mesh, m.st, NUM,
                                                 Experiment(), mm,
                                                 batched=True)
    st_s, sfx_s, corr_s, md_s = shard_inputs(mesh, True, state, m.sfx, corr,
                                             md)
    s1, corr1 = flux_sh(st_s, sfx_s, jnp.float32(298.0), md_s)
    s2, monthly, mf = scnr_sh(s1, sfx_s, corr1, jnp.float32(680.0), md_s)
    assert monthly.shape == (4, 2, 5, NUM.ydim, NUM.xdim)
    assert np.isfinite(np.asarray(monthly)).all()
    # members differ
    assert np.asarray(mf.ts).std(axis=0).max() > 1e-4


def test_refined_grid_sharded_compiles(need_devices):
    """Config-5 path (BASELINE.json): a refined grid domain-decomposed over
    latitude must LOWER AND COMPILE with the fori_loop polar sub-cycles
    (129 diffusion iterations/substep at 192x96) inside shard_map + halo
    exchange.  Running it is too slow on the CPU, so this is compile-only."""
    need_devices(4)
    from greb_tpu.forcing import forcing_from_arrays
    from greb_tpu.io.synthetic import make_synthetic_forcing
    from greb_tpu.regrid import regrid_forcing_arrays

    num = Numerics(xdim=192, ydim=96, ndays_yr=10, jday_mon=(6, 4),
                   time_flux=1, time_scnr=1)
    arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
    forcing = forcing_from_arrays(regrid_forcing_arrays(arrs, num))
    m = GREB(GrebConfig(numerics=num), forcing=forcing, verbose=False)
    assert m.grid.diff_sched.max_iter > 100   # the hard case

    mesh = make_mesh(n_ens=1, n_y=4)
    mm = jnp.asarray(month_average_matrix(num.jday_mon, num.ndt_days))
    flux_sh, scnr_sh = make_sharded_year_runners(mesh, m.st, num,
                                                 Experiment(), mm)
    s0 = m.initial_state()
    corr0 = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
    st_s, sfx_s, corr_s, md_s = shard_inputs(mesh, False, s0, m.sfx, corr0,
                                             m.md)
    co2 = jnp.float32(680.0)
    lowered = flux_sh.lower(st_s, sfx_s, co2, md_s)
    assert lowered.compile() is not None
    lowered2 = scnr_sh.lower(st_s, sfx_s, corr_s, co2, md_s)
    assert lowered2.compile() is not None
