"""Cross-grid climate consistency on the device, full 730-step calendar
(VERDICT r4 task 5's on-chip half; the CI half runs a reduced calendar on
CPU, tests/test_xgrid_consistency.py).

Runs the SAME experiment at 96x48 and 384x192 (synthetic climatology,
bilinearly regridded; 1 flux-correction year + N scenario years at 2xCO2),
coarse-averages the refined run's final-year annual-mean Tsurf to 96x48
(area weights) and reports global-mean / pattern-RMS agreement.  Prints
one JSON line.

Env: GREB_XGRID_YEARS (default 3).
"""
import json
import time

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from greb_tpu.runtime import enable_compile_cache
enable_compile_cache()

import numpy as np

from greb_tpu.config import Diagnostics, GrebConfig, Numerics
from greb_tpu.forcing import forcing_from_arrays
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model.driver import GREB
from greb_tpu.regrid import coarsen_field, regrid_forcing_arrays

F32 = np.float32
YEARS = int(os.environ.get("GREB_XGRID_YEARS", "3"))


def run(xd, yd):
    num = Numerics(xdim=xd, ydim=yd, time_flux=1, time_scnr=YEARS)
    arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
    forcing = forcing_from_arrays(regrid_forcing_arrays(arrs, num))
    m = GREB(GrebConfig(numerics=num, fast_circulation=True,
                        diagnostics=Diagnostics(console=False)),
             forcing=forcing, verbose=False)
    t0 = time.perf_counter()
    st, corr = m.flux_correction()
    _, monthly, _ = m.run_scenario(corr, years=YEARS,
                                   co2_series=np.full(YEARS, 680.0, F32),
                                   cap_surf=st.cap_surf)
    wall = time.perf_counter() - t0
    mon = np.asarray(monthly)           # (years, 12, 5, y, x)
    w = np.asarray(num.jday_mon, np.float64)
    w /= w.sum()
    ann_ts = (mon[-1, :, 0] * w[:, None, None]).sum(axis=0)
    print(f"# {xd}x{yd}: {wall:.1f}s (ext={m.grid.extension_mode})",
          file=sys.stderr)
    return ann_ts, m


ts_c, m_c = run(96, 48)
ts_f, m_f = run(384, 192)
assert m_f.grid.extension_mode and not m_c.grid.extension_mode

d = coarsen_field(ts_f, 96, 48) - ts_c
lat = -90.0 + 180.0 / 48 * (np.arange(48) + 0.5)
aw = np.cos(np.deg2rad(lat))[:, None] * np.ones((48, 96))
aw /= aw.sum()
tclim_ann = np.asarray(m_c.forcing.tclim).mean(axis=0)
ice = ((np.asarray(m_c.forcing.z_topo) <= 0) & (tclim_ann > 250.0)
       & (tclim_ann < 278.0))
w_out = aw * ~ice
w_ice = aw * ice
out = {
    "years": YEARS, "calendar": "730 steps/yr",
    "global_mean_dK": round(float((d * aw).sum()), 4),
    "rms_dK": round(float(np.sqrt((d * d * aw).sum())), 4),
    "rms_non_ice_dK": round(float(np.sqrt((d * d * w_out).sum()
                                          / w_out.sum())), 4),
    "rms_ice_zone_dK": round(float(np.sqrt((d * d * w_ice).sum()
                                           / w_ice.sum())), 4),
    "max_abs_dK": round(float(np.abs(d).max()), 3),
}
print(json.dumps(out))
assert abs(out["global_mean_dK"]) <= 0.1, out
assert out["rms_non_ice_dK"] <= 0.5, out
