"""Matmul ensemble-path parity (VERDICT r2 weak #5).

The config-3 ensemble path runs the zonal applies as row-batched matmuls
(ops/fastcirc2.build_mxu / mxu_circulation) — the matrices are exact
densifications of the 7-band coefficients, so with precision "highest"
(full float32, the default) results differ from the elementwise fold only
by matmul contraction order.  "high" lets the backend use reduced-precision
passes (TF32 on an H100).  This pins both against the vmapped elementwise
runner (itself oracle-anchored by tests/test_step.py and the golden year)
over a FULL 730-step year of flux correction + scenario.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from greb_tpu.config import GrebConfig, Numerics
from greb_tpu.model.driver import GREB
from greb_tpu.ops import fastcirc2 as fc2
from greb_tpu.parallel import ensemble as ens

CO2 = jnp.float32(680.0)
M = 2


def make_mxu_setup():
    """M members, full years: the reference runs of the tests below."""
    num = Numerics(time_flux=1, time_scnr=1)       # full 730-step years
    m = GREB(GrebConfig(numerics=num, fast_circulation=True), verbose=False)
    plan, (const,) = m._fastcirc_split()
    perturb = {"ct_sens": np.float32(22.5)
               * (1.0 + 0.02 * np.linspace(-1, 1, M, dtype=np.float32))}
    pb = ens.perturbed_params(m.params, perturb)
    state_b = ens.ensemble_initial_state(
        pb, m.forcing, ens.ensemble_data(pb, m.forcing, m.sf))
    # reference: the vmap/VPU-fold ensemble runner
    md_v = ens.ensemble_data(pb, m.forcing, m.sf)
    flux_v, scnr_v = ens.make_ensemble_runners(m.st, m.num, m.exp,
                                               m.month_mat, fast_plan=plan)
    sv, corr_v = flux_v(state_b, m.sfx, CO2, md_v, (const,))
    sv2, mon_v, _ = scnr_v(sv, m.sfx, corr_v, CO2, md_v, (const,))
    md_b = ens.batched_model_data(pb, m.forcing, m.sf)
    return m, plan, const, pb, state_b, md_b, corr_v, sv2, mon_v


@pytest.fixture(scope="module")
def mxu_setup():
    return make_mxu_setup()


def _run_mxu(mxu_setup, precision):
    m, plan, const, pb, state_b, md_b, corr_v, sv2, mon_v = mxu_setup
    mxu = fc2.build_mxu(const, plan, precision=precision)
    flux_b, scnr_b = ens.make_batched_ensemble_runners(
        m.st, m.num, m.exp, m.month_mat, fast_plan=plan)
    sb, corr_b = flux_b(state_b, m.sfx, CO2, md_b, (const, mxu))
    sb2, mon_b, _ = scnr_b(sb, m.sfx, corr_b, CO2, md_b, (const, mxu))
    d_tf = np.abs(np.asarray(corr_b.tf).transpose(1, 0, 2, 3)
                  - np.asarray(corr_v.tf)).max()
    dm = np.abs(np.asarray(mon_b) - np.asarray(mon_v))
    d_mon = dm.max()
    rms_mon = float(np.sqrt((dm.astype(np.float64) ** 2).mean()))
    d_ts = np.abs(np.asarray(sb2.ts) - np.asarray(sv2.ts)).max()
    return d_tf, d_mon, d_ts, rms_mon


def test_mxu_highest_matches_vpu_fold(mxu_setup):
    """Full-f32 matmuls vs the elementwise fold: differences are matmul
    contraction order only — sub-millikelvin after a full year."""
    d_tf, d_mon, d_ts, _ = _run_mxu(mxu_setup, "highest")
    assert d_ts < 5e-3, d_ts                     # K, end-of-year state
    assert d_mon < 5e-3, d_mon                   # monthly means (mixed units)
    assert d_tf < 5.0, d_tf                      # W/m^2 (cap_surf/dt scale:
    #                                              ~1e4 x the K-scale diff)


def test_mxu_high_error_budget(mxu_setup):
    """Precision "high" vs the elementwise fold over a full year, with the
    bounds of the backend this suite runs on (the CPU computes "high" in
    float32); the GPU's TF32 bounds are test_mxu_high_error_budget_gpu."""
    d_tf, d_mon, d_ts, rms_mon = _run_mxu(mxu_setup, "high")
    assert d_ts < 5e-2, d_ts
    assert rms_mon < 5e-3, rms_mon
    assert d_mon < 5e-2, d_mon
    assert d_tf < 50.0, d_tf


# Precision "high" on an H100 (TF32) vs the elementwise fold after one
# flux-correction + one scenario year at 96x48.  About 3x the error measured
# on the card with 8 members in stacked mode (monthly max 1.25, RMS 0.086;
# end-state ts max 0.45; TF table max 29 W/m^2 — PERF.md).  This test's own
# set-up (M members, pair mode) measured far less there (monthly max 5.2e-4):
# what TF32 costs depends on the shapes and mode XLA gets, so the bounds
# hold the worse case.
GPU_HIGH_BOUNDS = {"d_mon": 4.0, "rms_mon": 0.25, "d_ts": 1.5, "d_tf": 90.0}


def check_high_error_gpu(setup) -> dict:
    """The body of test_mxu_high_error_budget_gpu; returns the errors."""
    d_tf, d_mon, d_ts, rms_mon = _run_mxu(setup, "high")
    errs = {"d_mon": float(d_mon), "rms_mon": rms_mon, "d_ts": float(d_ts),
            "d_tf": float(d_tf)}
    for k, bound in GPU_HIGH_BOUNDS.items():
        assert errs[k] < bound, (k, errs[k], bound)
    return errs


@pytest.mark.gpu
def test_mxu_high_error_budget_gpu(mxu_setup):
    check_high_error_gpu(mxu_setup)


def test_build_mxu_defaults_to_highest():
    """The ensemble matmuls keep the single-run float32 contract unless a
    caller asks for "high"."""
    import inspect
    assert inspect.signature(fc2.build_mxu).parameters[
        "precision"].default == "highest"
    assert fc2.MxuConst.__dataclass_fields__["precision"].default \
        == "highest"


def test_mxu_densification_is_exact():
    """The dense row matrices reproduce the banded coefficients exactly:
    applying zd_mat to one-hot vectors recovers zd bit-for-bit, and the
    advection densification (exact one-hot shift tensors) matches
    step_coeffs output."""
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    m = GREB(GrebConfig(numerics=num, fast_circulation=True), verbose=False)
    plan, (const,) = m._fastcirc_split()
    mxu = fc2.build_mxu(const, plan)
    zd = np.asarray(const.zd)                    # (7, F, Y, X)
    zmat = np.asarray(mxu.zd_mat)                # (F, Y, X, X)
    _, F, Y, X = zd.shape
    from greb_tpu.ops.fastcirc import _LON_IDX_SHIFT
    jout = np.arange(X)
    np.testing.assert_array_equal(zmat[:, :, jout, jout], zd[3])
    for i, s in _LON_IDX_SHIFT:
        np.testing.assert_array_equal(zmat[:, :, (jout - s) % X, jout],
                                      zd[i])
    cf = fc2.step_coeffs(m.forcing.uclim[0], m.forcing.vclim[0], const, plan)
    za_mat = np.asarray(fc2.adv_matrix(cf.za, mxu))
    za = np.asarray(cf.za)
    np.testing.assert_array_equal(za_mat[:, :, jout, jout], za[3])
    for i, s in _LON_IDX_SHIFT:
        np.testing.assert_array_equal(za_mat[:, :, (jout - s) % X, jout],
                                      za[i])


def test_mxu_fused_error_budget(mxu_setup):
    """Fused interior apply (zc = wz*zd + za pre-folded into ONE per-row
    matrix): the coefficient pre-fold rounds before the cancellation-heavy
    stencil sum, so the increment carries ~1e-4 relative error per substep
    — same class as the production bf16_3x budget.  Pinned over a full
    year vs the VPU fold."""
    m, plan, const, pb, state_b, md_b, corr_v, sv2, mon_v = mxu_setup
    mxu = fc2.build_mxu(const, plan, precision="highest", mode="fused")
    flux_b, scnr_b = ens.make_batched_ensemble_runners(
        m.st, m.num, m.exp, m.month_mat, fast_plan=plan)
    sb, corr_b = flux_b(state_b, m.sfx, CO2, md_b, (const, mxu))
    sb2, mon_b, _ = scnr_b(sb, m.sfx, corr_b, CO2, md_b, (const, mxu))
    d_mon = np.abs(np.asarray(mon_b) - np.asarray(mon_v)).max()
    d_ts = np.abs(np.asarray(sb2.ts) - np.asarray(sv2.ts)).max()
    assert d_ts < 1e-1, d_ts
    assert d_mon < 1e-1, d_mon
    assert np.isfinite(np.asarray(sb2.ts)).all()


def test_mxu_fused_single_step_parity():
    """24-substep circulation: fused vs unfused MXU vs VPU fold on a
    member batch — tight bound, one step (no year-scale accumulation)."""
    import jax.numpy as jnp
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    m = GREB(GrebConfig(numerics=num, fast_circulation=True), verbose=False)
    plan, (const,) = m._fastcirc_split()
    mxu_u = fc2.build_mxu(const, plan, precision="highest")
    mxu_f = fc2.build_mxu(const, plan, precision="highest", mode="fused")
    s0 = m.initial_state()
    x = jnp.stack([jnp.stack([s0.ta + 0.1 * i, s0.q * (1 + 0.01 * i)])
                   for i in range(3)])
    cf = fc2.step_coeffs(m.forcing.uclim[0], m.forcing.vclim[0], const, plan)
    d_u = fc2.mxu_circulation(x, cf, const, mxu_u, plan, nsub=24)
    d_f = fc2.mxu_circulation(x, cf, const, mxu_f, plan, nsub=24)
    d_v = fc2.circulation(x, cf, const, plan, nsub=24)
    # ta increments O(6 K), q increments O(2e-3): bound per field
    assert float(jnp.abs(d_f[:, 0] - d_u[:, 0]).max()) < 5e-3
    assert float(jnp.abs(d_f[:, 0] - d_v[:, 0]).max()) < 5e-3
    assert float(jnp.abs(d_f[:, 1] - d_u[:, 1]).max()) < 5e-6
    assert float(jnp.abs(d_f[:, 1] - d_v[:, 1]).max()) < 5e-6


def test_mxu_stacked_bit_identical():
    """mode="stacked" concatenates the two matrices along the output dim —
    each output column's dot is unchanged, so results are BIT-identical to
    mode="pair" at the same precision."""
    import jax.numpy as jnp
    num = Numerics(ndays_yr=10, jday_mon=(6, 4), time_flux=1, time_scnr=1)
    m = GREB(GrebConfig(numerics=num, fast_circulation=True), verbose=False)
    plan, (const,) = m._fastcirc_split()
    mxu_p = fc2.build_mxu(const, plan, precision="highest")
    mxu_s = fc2.build_mxu(const, plan, precision="highest", mode="stacked")
    s0 = m.initial_state()
    x = jnp.stack([jnp.stack([s0.ta + 0.1 * i, s0.q * (1 + 0.01 * i)])
                   for i in range(3)])
    cf = fc2.step_coeffs(m.forcing.uclim[0], m.forcing.vclim[0], const, plan)
    d_p = fc2.mxu_circulation(x, cf, const, mxu_p, plan, nsub=24)
    d_s = fc2.mxu_circulation(x, cf, const, mxu_s, plan, nsub=24)
    np.testing.assert_array_equal(np.asarray(d_p), np.asarray(d_s))
