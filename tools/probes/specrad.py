"""Measure the spectral radius of the LINEARIZED extension-mode substep.

Power-iterates the real coefficient-folded substep (clamps disabled — they
are inactive for small perturbations around a positive state) on an
extension grid with a UNIFORM worst-case wind, to adjudicate the Fourier
budget in grid.py against a first-principles measurement.

  python tools/probes/specrad.py [XxY] [dt_crcl] [wind]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from greb_tpu.runtime import enable_compile_cache
enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

from greb_tpu.config import GrebConfig, Numerics
from greb_tpu.forcing import forcing_from_arrays
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model.driver import GREB
from greb_tpu.ops import fastcirc as v1
from greb_tpu.ops import fastcirc2 as fc2
from greb_tpu.ops.fastcirc import _LON_IDX_SHIFT
from greb_tpu.regrid import regrid_forcing_arrays

shape = sys.argv[1] if len(sys.argv) > 1 else "384x192"
dtc = int(sys.argv[2]) if len(sys.argv) > 2 else 1800
wind = sys.argv[3] if len(sys.argv) > 3 else "13.0"   # m/s | "forcing"
X, Y = (int(s) for s in shape.split("x"))

num = Numerics(xdim=X, ydim=Y, dt_crcl=dtc, ndays_yr=1, jday_mon=(1,),
               time_flux=0, time_scnr=1)
arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
forcing = forcing_from_arrays(regrid_forcing_arrays(arrs, num))
m = GREB(GrebConfig(numerics=num, fast_circulation=True), forcing=forcing,
         verbose=False)
splan, sconst = fc2.build_sharded(
    np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
    m.grid, m.st, kappa=float(m.params.kappa), n_shards=1,
    comp_dense_max_bytes=2 ** 31)

# disable the positivity clamps: linear analysis
fc2._masked_clamp = lambda d, x, band: d
v1._clamped = lambda d, x: d

if wind == "forcing":
    # worst step of the real (synthetic) climatology: per-cell max |u|, |v|
    u = jnp.asarray(np.abs(np.asarray(m.sfx.u)).max(axis=0))
    v = jnp.asarray(np.abs(np.asarray(m.sfx.v)).max(axis=0))
    print("forcing winds: global max |u|", float(u.max()),
          " polar-row max |u|:",
          float(u[np.asarray(m.grid.diff_sched.time2) > 1].max()))
else:
    u = jnp.full((Y, X), float(wind), jnp.float32)
    v = jnp.zeros((Y, X), jnp.float32)
cf = fc2.step_coeffs(u, v, sconst, splan)


@jax.jit
def sub(x):
    return fc2.sharded_substep(x, cf, sconst, splan, fc2.extend_lat_zero)


rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal((2, Y, X)), jnp.float32)
x = x / jnp.linalg.norm(x)
growth = []
for i in range(400):
    x2 = sub(x)
    g = float(jnp.linalg.norm(x2))
    growth.append(g)
    x = x2 / g
    if (i + 1) % 50 == 0:
        print(f"iter {i+1}: growth/substep = {g:.6f} "
              f"(geo-mean last 50: {np.exp(np.mean(np.log(growth[-50:]))):.6f})",
              flush=True)
print(f"FINAL spectral-radius estimate at wind={wind} m/s, {shape}@{dtc}: "
      f"{np.exp(np.mean(np.log(growth[-100:]))):.6f}")
