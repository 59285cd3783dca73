"""Per-row spectral radius of the zonal diffusion substep operator at 768x384
(power iteration, all rows at once)."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from greb_tpu.runtime import enable_compile_cache
enable_compile_cache()
import numpy as np
from greb_tpu.config import GrebConfig, Numerics
from greb_tpu.forcing import forcing_from_arrays
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.regrid import regrid_forcing_arrays
from greb_tpu.model.driver import GREB
from greb_tpu.ops import fastcirc2 as fc2
from greb_tpu.ops.fastcirc import _LON_IDX_SHIFT

num = Numerics(xdim=768, ydim=384, ndays_yr=1, jday_mon=(1,), time_flux=0, time_scnr=1)
arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
forcing = forcing_from_arrays(regrid_forcing_arrays(arrs, num))
m = GREB(GrebConfig(numerics=num, fast_circulation=True), forcing=forcing, verbose=False)
g = m.grid
plan, const = fc2.build_const(np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
                              g, m.st, kappa=float(m.params.kappa))
zd = np.asarray(const.zd, np.float64)  # (7,F,Y,X)
wz = np.asarray(const.wz, np.float64)  # (F,Y,X)

def apply7(v):
    d = zd[3] * v
    for i, s in _LON_IDX_SHIFT:
        d = d + zd[i] * np.roll(v, s, axis=-1)
    return d

rng = np.random.default_rng(0)
v = rng.standard_normal((2, 384, 768))
d2 = np.asarray(g.diff_sched.time2)
# the per-substep operator for time2==1 rows is (I + wz*C) (outer wz applies to
# the single iteration's increment); for composite rows it's wz*( (I+C)^n - I ) + I.
# Probe the time2==1 rows' operator: v + wz*apply7(v)
growth = np.ones((2, 384))
for it in range(200):
    v = v + wz * apply7(v)
    nrm = np.sqrt((v * v).mean(axis=-1)) + 1e-300
    growth = nrm
    v = v / nrm[..., None]
rho = growth  # per-iteration growth after convergence
for f in range(2):
    bad = np.where(rho[f] > 1.0 + 1e-9)[0]
    print(f"field {f}: rows with rho>1: {len(bad)}", bad[:20], "max rho:", rho[f].max(),
          "argmax row:", rho[f].argmax(), "time2 there:", d2[rho[f].argmax()])
# print c and rho profile around the worst rows
f = int(np.unravel_index(rho.argmax(), rho.shape)[0])
k0 = int(rho[f].argmax())
ccd_eff = None
for k in range(max(0, k0-3), min(384, k0+4)):
    c = float(m.params.kappa) * g.diff_sched.dtdff2[k] / (g.dxlat[k]**2)
    print(f"row {k:3d} lat={g.lat[k]:7.2f} time2={d2[k]:6d} c={c:7.4f} rho={rho[f][k]:.6f}")
