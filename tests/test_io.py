"""IO tests: binary record formats, namelist parsing, synthetic generator,
native C++ fast path, checkpointing."""
import os

import numpy as np
import pytest

from greb_tpu.config import Numerics, config_from_namelist
from greb_tpu.io import binio
from greb_tpu.io.namelist import parse_namelist, read_namelist, write_namelist
from greb_tpu.io.synthetic import INPUT_FILES, make_synthetic_forcing, write_forcing_dir

F32 = np.float32
DATA = os.path.join(os.path.dirname(__file__), "data")


def test_record_roundtrip(tmp_path):
    data = np.arange(3 * 48 * 96, dtype=F32).reshape(3, 48, 96)
    p = str(tmp_path / "recs")
    binio.write_records(p, data)
    back = binio.read_records(p, (48, 96))
    np.testing.assert_array_equal(back, data)
    # partial, out-of-order reads (Fortran 1-based record indices)
    sel = binio.read_records(p, (48, 96), records=[3, 1])
    np.testing.assert_array_equal(sel[0], data[2])
    np.testing.assert_array_equal(sel[1], data[0])


def test_native_matches_numpy(tmp_path):
    from greb_tpu.io.native_recordio import NativeRecordIO
    nat = NativeRecordIO.try_load()
    if nat is None:
        pytest.skip("native librecordio.so not built")
    data = np.random.default_rng(0).standard_normal((10, 48, 96)).astype(F32)
    p = str(tmp_path / "recs")
    nat.write(p, 48 * 96 * 4, 0, data)
    assert nat.n_records(p, 48 * 96 * 4) == 10
    raw = nat.read(p, 48 * 96 * 4, [4, 0, 9], nthreads=2)
    got = raw.view(F32).reshape(3, 48, 96)
    np.testing.assert_array_equal(got[0], data[4])
    np.testing.assert_array_equal(got[1], data[0])
    np.testing.assert_array_equal(got[2], data[9])


def test_forcing_dir_roundtrip(tmp_path):
    """Synthetic forcing -> reference-format input dir -> load_forcing."""
    from greb_tpu.forcing import load_forcing
    num = Numerics(ndays_yr=4, jday_mon=(2, 2))
    f = make_synthetic_forcing(num.xdim, num.ydim, num.nstep_yr, num.ndays_yr)
    d = str(tmp_path / "input")
    write_forcing_dir(f, d)
    for fname in INPUT_FILES.values():
        assert os.path.exists(os.path.join(d, fname))
    clim = load_forcing(d, num)
    np.testing.assert_array_equal(np.asarray(clim.tclim), f["tclim"])
    np.testing.assert_array_equal(np.asarray(clim.z_topo), f["z_topo"])
    np.testing.assert_array_equal(np.asarray(clim.sw_solar), f["sw_solar"])


def test_load_reference_static_inputs():
    """The real static inputs shipped with the reference load correctly."""
    ref = "/root/reference/input"
    if not os.path.isdir(ref):
        pytest.skip("reference inputs not mounted")
    z = binio.read_records(os.path.join(ref, "topography"), (48, 96),
                           records=[1])[0]
    assert z.shape == (48, 96)
    assert z.min() == np.float32(-0.1)          # flat ocean marker
    assert 5000 < z.max() < 6000                # Himalaya-scale peak
    sw = binio.read_records(os.path.join(ref, "solar.radiation"), (730, 48),
                            records=[1])[0]
    assert sw.min() >= 0.0 and 500 < sw.max() < 600
    g = binio.read_records(os.path.join(ref, "glacier.masks"), (48, 96),
                           records=[1])[0]
    assert set(np.unique(g)) <= {0.0, 1.0}


def test_namelist_parse_reference_files():
    groups = read_namelist(os.path.join(DATA, "namelist"))
    assert groups["numerics_par"]["time_flux"] == 3
    assert groups["numerics_par"]["time_scnr"] == 50
    assert groups["numerics_par"]["ipx"] == 95
    assert groups["diagnostics_par"]["output_file"] == "output/scenario"
    assert groups["co2_par"]["co2_ppm"] == 680
    legacy = read_namelist(os.path.join(DATA, "namelist_original"))
    assert legacy["physics"]["log_exp"] == 10
    assert legacy["numerics"]["time_ctrl"] == 3


def test_namelist_features():
    text = """
&PHYSICS_PAR
kappa = 9.0e5   ! perturbed
p_emi = 9.0, 106.0, 3*61.0,
        0.1, 0.2, 0.3, 0.4, 0.5
log_flag = .true.
name = "hello world"
/
&CO2_PAR
co2_ppm = 340, 360, 380
/
"""
    g = parse_namelist(text)
    assert g["physics_par"]["kappa"] == 9.0e5
    assert g["physics_par"]["p_emi"] == [9.0, 106.0, 61.0, 61.0, 61.0,
                                         0.1, 0.2, 0.3, 0.4, 0.5]
    assert g["physics_par"]["log_flag"] is True
    assert g["physics_par"]["name"] == "hello world"
    assert g["co2_par"]["co2_ppm"] == [340, 360, 380]


def test_namelist_roundtrip(tmp_path):
    g = {"numerics_par": {"time_flux": 3, "time_scnr": 50},
         "co2_par": {"co2_ppm": [680.0, 700.0]},
         "diagnostics_par": {"output_file": "out/x"}}
    p = str(tmp_path / "nml")
    write_namelist(g, p)
    back = read_namelist(p)
    assert back["numerics_par"]["time_flux"] == 3
    assert back["co2_par"]["co2_ppm"] == [680.0, 700.0]
    assert back["diagnostics_par"]["output_file"] == "out/x"


def test_config_from_reference_namelist():
    cfg, params = config_from_namelist(os.path.join(DATA, "namelist"))
    assert cfg.numerics.time_flux == 3
    assert cfg.numerics.time_scnr == 50
    assert cfg.numerics.ipx == 95 and cfg.numerics.ipy == 38
    assert cfg.diagnostics.output_file == "output/scenario"
    assert cfg.co2.series(cfg.numerics.time_scnr)[0] == 680.0
    assert (cfg.co2.series(50) == 680.0).all()
    assert not cfg.experiment.active
    assert float(params.kappa) == 8e5


def test_co2_series_padding():
    from greb_tpu.config import CO2Params
    s = CO2Params(co2_ppm=(340.0, 360.0)).series(5)
    np.testing.assert_array_equal(s, [340, 360, 360, 360, 360])
    s = CO2Params().series(3)
    np.testing.assert_array_equal(s, [680, 680, 680])


def test_synthetic_forcing_contract():
    f = make_synthetic_forcing(96, 48, 730)
    assert f["tclim"].shape == (730, 48, 96)
    assert f["sw_solar"].shape == (730, 48)
    assert f["z_topo"].min() == np.float32(-0.1)  # reference ocean marker
    assert (f["mldclim"] > 0).all()
    assert (f["qclim"] > 0).all()
    assert (f["swetclim"] >= 0).all() and (f["swetclim"] <= 1).all()
    assert (f["cldclim"] >= 0).all() and (f["cldclim"] <= 1).all()
    assert (np.abs(f["uclim"]) < 50).all()
    assert (f["tclim"] > 200).all() and (f["tclim"] < 330).all()
    # deterministic
    f2 = make_synthetic_forcing(96, 48, 730)
    np.testing.assert_array_equal(f["tclim"], f2["tclim"])


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    from greb_tpu.forcing import Corrections, ModelState
    from greb_tpu.io.checkpoint import (Checkpointer, RunCursor,
                                        load_checkpoint, save_checkpoint)
    rng = np.random.default_rng(1)
    mk = lambda: jnp.asarray(rng.standard_normal((48, 96)).astype(F32))
    state = ModelState(ts=mk(), ta=mk(), to=mk(), q=mk(), cap_surf=mk())
    corr = Corrections(
        tf=jnp.asarray(rng.standard_normal((4, 48, 96)).astype(F32)),
        tof=jnp.asarray(rng.standard_normal((4, 48, 96)).astype(F32)),
        qf=jnp.asarray(rng.standard_normal((4, 48, 96)).astype(F32)))
    cur = RunCursor(phase="scenario", year_index=7, co2=680.0)

    p = str(tmp_path / "ck")
    save_checkpoint(p, state, corr, cur)
    s2, c2, cur2 = load_checkpoint(p)
    np.testing.assert_array_equal(np.asarray(s2.ts), np.asarray(state.ts))
    np.testing.assert_array_equal(np.asarray(c2.qf), np.asarray(corr.qf))
    assert cur2.year_index == 7 and cur2.phase == "scenario"

    ck = Checkpointer(str(tmp_path / "mgr"), every_years=2, keep=2)
    assert not ck.maybe_save(0, state, corr, cur)
    assert ck.maybe_save(1, state, corr, cur)
    assert ck.maybe_save(3, state, corr, cur)
    step = ck.latest_step()
    assert step == 3
    s3, c3, cur3 = ck.restore()
    np.testing.assert_array_equal(np.asarray(s3.q), np.asarray(state.q))
    assert cur3.co2 == 680.0
