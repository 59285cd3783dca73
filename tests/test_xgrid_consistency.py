"""Cross-grid climate consistency (VERDICT r4 task 5).

The extension grids (384x192, 768x384) run a SEQUENTIAL zonal splitting
and capped sub-cycle schedules that the reference cannot express (its
additive splitting amplifies at deep rows and its integer sub-step count
truncates to zero there, src/greb.f90:546-550,652-654).  Stability of
that scheme is gated numerically (tests/test_extension_stability.py);
THIS test asserts the refined grid produces the SAME CLIMATE as the base
grid, not just a stable one: a 384x192 run coarse-averaged to 96x48 must
match the 96x48 run within a physical tolerance.

Both runs are spun up with the flux correction against the SAME
climatology (bilinearly regridded for the fine grid), so away from the
sea-ice zone the annual-mean Ts fields must agree closely.  Inside the
sea-ice zone cap_surf switches ~40x across the ice-ramp thresholds
(src/greb.f90:483-487): a refined grid resolves the ice edge differently
by construction, and the reduced CI calendar (10-day years) amplifies the
edge flip-flop, so those cells carry a looser bound.  The full-calendar
run on the device is tools/probes/xgrid.py.
"""
import numpy as np
import pytest

from greb_tpu.config import Diagnostics, GrebConfig, Numerics
from greb_tpu.forcing import forcing_from_arrays
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model.driver import GREB
from greb_tpu.regrid import coarsen_field, regrid_forcing_arrays

F32 = np.float32
NDAYS, JDAY, YEARS = 10, (6, 4), 2


def _annual_ts(xd: int, yd: int):
    """Flux-corrected spin-up + YEARS at 2xCO2; returns the final year's
    annual-mean Tsurf and the (coarse-resolution inputs') forcing fields."""
    num = Numerics(xdim=xd, ydim=yd, ndays_yr=NDAYS, jday_mon=JDAY,
                   time_flux=1, time_scnr=YEARS)
    arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
    forcing = forcing_from_arrays(regrid_forcing_arrays(arrs, num))
    m = GREB(GrebConfig(numerics=num, fast_circulation=True,
                        diagnostics=Diagnostics(console=False)),
             forcing=forcing, verbose=False)
    st, corr = m.flux_correction()
    _, monthly, _ = m.run_scenario(
        corr, years=YEARS, co2_series=np.full(YEARS, 680.0, F32),
        cap_surf=st.cap_surf)
    mon = np.asarray(monthly)
    w = np.asarray(JDAY, np.float64)
    w /= w.sum()
    ann = (mon[-1, :, 0] * w[:, None, None]).sum(axis=0)
    return ann, m


def test_refined_grid_same_climate():
    """384x192 (extension mode: sequential splitting, capped schedules)
    coarse-averaged to 96x48 reproduces the 96x48 climate."""
    ts_c, m_c = _annual_ts(96, 48)
    gx = m_c.grid
    assert not gx.extension_mode
    ts_f, m_f = _annual_ts(384, 192)
    assert m_f.grid.extension_mode     # the scheme under test is active

    ts_fc = coarsen_field(ts_f, 96, 48)
    d = ts_fc - ts_c
    lat = -90.0 + 180.0 / 48 * (np.arange(48) + 0.5)
    aw = np.cos(np.deg2rad(lat))[:, None] * np.ones((48, 96))
    aw /= aw.sum()

    gm = float((d * aw).sum())
    assert abs(gm) <= 0.1, f"global-mean Ts differs by {gm:+.3f} K"

    # sea-ice zone: ocean cells whose annual-mean climatology sits in the
    # ice-ramp range — the ice edge is genuinely resolution-dependent there
    tclim_ann = np.asarray(m_c.forcing.tclim).mean(axis=0)
    ocean = np.asarray(m_c.forcing.z_topo) <= 0
    ice_zone = ocean & (tclim_ann > 250.0) & (tclim_ann < 278.0)

    w_out = aw * ~ice_zone
    rms_out = float(np.sqrt((d * d * w_out).sum() / w_out.sum()))
    assert rms_out <= 1.2, \
        f"non-ice-zone Ts pattern RMS {rms_out:.3f} K (measured ~0.86)"

    w_ice = aw * ice_zone
    rms_ice = float(np.sqrt((d * d * w_ice).sum() / w_ice.sum()))
    assert rms_ice <= 5.0, \
        f"ice-zone Ts pattern RMS {rms_ice:.3f} K (measured ~3.2)"


def test_coarsen_field_properties():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((192, 384)).astype(F32)
    out = coarsen_field(a, 96, 48)
    assert out.shape == (48, 96)
    # constant fields are preserved exactly
    np.testing.assert_allclose(coarsen_field(np.full((192, 384), 2.5, F32),
                                             96, 48), 2.5, rtol=1e-6)
    # the global area-weighted mean is conserved
    def gmean(f):
        y = f.shape[0]
        la = -90.0 + 180.0 / y * (np.arange(y) + 0.5)
        w = np.cos(np.deg2rad(la))[:, None] * np.ones_like(f)
        return float((f * w / w.sum()).sum())
    assert abs(gmean(out) - gmean(a)) < 1e-6
    # identity when the grids match
    np.testing.assert_array_equal(coarsen_field(a, 384, 192), a)
