"""768x384 (config-5 grid) stability demonstration on one device.

Runs the production sharded fast path on a 1-device mesh at dt_crcl=450
with a reduced calendar (60 steps/yr keeps the synthetic forcing small),
integrating YEARS years (96 substeps/step).
Asserts a physical temperature range after every year — the round-2
blow-up reached 1e7 K within 2 steps, so thousands of stable substeps
demonstrate the capped extension schedules hold at scale."""
import time
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from greb_tpu.runtime import enable_compile_cache
enable_compile_cache()
import numpy as np, jax, jax.numpy as jnp

from greb_tpu.config import GrebConfig, Numerics
from greb_tpu.forcing import Corrections, forcing_from_arrays
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.regrid import regrid_forcing_arrays
from greb_tpu.model.driver import GREB
from greb_tpu.ops import fastcirc2 as fc2
from greb_tpu.parallel.sharded import (make_mesh, make_sharded_year_runners,
                                       shard_fastcirc, shard_inputs)

YEARS = int(os.environ.get("YEARS", "5"))
num = Numerics(xdim=768, ydim=384, dt_crcl=450, ndays_yr=30,
               jday_mon=(16, 14), time_flux=1, time_scnr=YEARS)
arrs = make_synthetic_forcing(96, 48, num.nstep_yr, num.ndays_yr)
forcing = forcing_from_arrays(regrid_forcing_arrays(arrs, num))
m = GREB(GrebConfig(numerics=num, fast_circulation=True), forcing=forcing,
         verbose=False)
mesh = make_mesh(n_ens=1, n_y=jax.device_count())
splan, sconst = fc2.build_sharded(
    np.asarray(m.derived.wz_air), np.asarray(m.derived.wz_vapor),
    m.grid, m.st, kappa=float(m.params.kappa),
    n_shards=jax.device_count(), comp_dense_max_bytes=2 ** 31)
print(f"plan: {splan.comp_mode}, kct/kcb {splan.kct}/{splan.kcb}, "
      f"la_levels {splan.la_levels}, nsub {num.nsub_crcl}", flush=True)
sconst_sh = shard_fastcirc(mesh, sconst)
flux_sh, scnr_sh = make_sharded_year_runners(mesh, m.st, num, m.exp,
                                             m.month_mat, fast_plan=splan)
corr0 = Corrections.zeros(num.nstep_yr, num.ydim, num.xdim)
state_s, sfx_s, corr_s, md_s = shard_inputs(mesh, False, m.initial_state(),
                                            m.sfx, corr0, m.md)
s, corr_s = flux_sh(state_s, sfx_s, jnp.float32(298.0), md_s, sconst_sh)
ts = np.asarray(s.ts)
print(f"flux yr: Ts [{ts.min():.1f}, {ts.max():.1f}] K", flush=True)
t0 = time.perf_counter()
for y in range(YEARS):
    s, monthly, _ = scnr_sh(s, sfx_s, corr_s, jnp.float32(680.0), md_s,
                            sconst_sh)
    ts = np.asarray(s.ts)
    assert np.isfinite(ts).all()
    assert 150.0 < ts.min() and ts.max() < 400.0, (ts.min(), ts.max())
    print(f"yr {y+1}: Ts [{ts.min():.1f}, {ts.max():.1f}] K, "
          f"mean {ts.mean():.2f}", flush=True)
dt = time.perf_counter() - t0
substeps = YEARS * num.nstep_yr * num.nsub_crcl
print(f"STABLE: {YEARS} yr x {num.nstep_yr} steps x {num.nsub_crcl} substeps"
      f" = {substeps} substeps at 768x384; {YEARS/dt:.2f} yr/s "
      f"({dt/substeps*1e6:.0f} us/substep)", flush=True)
