"""Localize the 768x384 instability: run substep components separately."""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from greb_tpu.runtime import enable_compile_cache
enable_compile_cache()
import numpy as np, jax, jax.numpy as jnp
from greb_tpu.config import GrebConfig, Numerics
from greb_tpu.forcing import forcing_from_arrays
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.regrid import regrid_forcing_arrays
from greb_tpu.model.driver import GREB
from greb_tpu.ops import fastcirc2 as fc2
from greb_tpu.ops import fastcirc as v1
from greb_tpu.ops.fastcirc import _LON_IDX_SHIFT

num = Numerics(xdim=768, ydim=384, dt_crcl=900, ndays_yr=1, jday_mon=(1,), time_flux=0, time_scnr=1)
arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
forcing = forcing_from_arrays(regrid_forcing_arrays(arrs, num))
m = GREB(GrebConfig(numerics=num, fast_circulation=True), forcing=forcing, verbose=False)
splan, sconst = fc2.build_sharded(np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
                                  m.grid, m.st, kappa=float(m.params.kappa), n_shards=1,
                                  comp_dense_max_bytes=2**31)
print("plan:", splan.comp_mode, "kct/kcb:", splan.kct, splan.kcb, "lat/lab:", splan.lat, splan.lab,
      "la_levels:", splan.la_levels, flush=True)

state = m.initial_state()
fx0 = jax.tree.map(lambda a: np.asarray(a)[0], m.sfx)  # step 0 forcing
u = jnp.asarray(fx0.u); v = jnp.asarray(fx0.v)
print("wind max |u|,|v|:", float(jnp.abs(u).max()), float(jnp.abs(v).max()), flush=True)
cf = fc2.step_coeffs(u, v, sconst, splan)
x0 = jnp.stack([state.ta, state.q])  # (F, Y, X)

def run(variant, nsub=192):
    def sub(x):
        R = x.shape[-2]
        rolls = [jnp.roll(x, s, axis=-1) for _, s in _LON_IDX_SHIFT]
        dd = fc2._apply7_rolled(rolls, x, sconst.zd)
        dd = fc2._masked_clamp(dd, x, sconst.band)
        if variant in ("full", "diff+comp", "nodiffextra_yes_adv"):
            if variant != "nodiffextra_yes_adv":
                dd = fc2._sharded_extra_diffusion(x, dd, sconst, splan)
        da = fc2._apply7_rolled(rolls, x, cf.za)
        da = fc2._masked_clamp(da, x, sconst.band)
        if variant in ("full", "adv+levels", "nodiffextra_yes_adv"):
            da = fc2._sharded_extra_advection(x, da, cf, sconst.amask, splan)
        xe = fc2.extend_lat_zero(x, 2)
        dy = cf.c0m * x
        dy = dy + cf.mc[0] * xe[..., 0:R, :]
        dy = dy + cf.mc[1] * xe[..., 1:R + 1, :]
        dy = dy + cf.mc[2] * xe[..., 3:R + 3, :]
        dy = dy + cf.mc[3] * xe[..., 4:R + 4, :]
        if variant == "meronly":
            return x + dy
        if variant == "diffbase":
            return x + sconst.wz * dd + dy
        if variant == "diff+comp":
            return x + sconst.wz * dd + dy
        if variant == "advbase":
            return x + da + dy
        if variant == "adv+levels":
            return x + da + dy
        return x + sconst.wz * dd + da + dy
    f = jax.jit(sub)
    x = x0
    hist = []
    for i in range(nsub):
        x = f(x)
        if (i+1) % 8 == 0 or i == 0:
            ta = np.asarray(x[0]); q = np.asarray(x[1])
            hist.append((i+1, float(np.abs(ta).max()), float(np.abs(q).max())))
    print(f"{variant:22s}", " ".join(f"[{n}] Ta={a:.4g} q={b:.4g}" for n, a, b in hist), flush=True)

for vnt in ["meronly", "diffbase", "diff+comp", "advbase", "adv+levels", "nodiffextra_yes_adv", "full"]:
    run(vnt)
