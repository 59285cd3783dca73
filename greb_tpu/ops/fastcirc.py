"""Coefficient-folded fast circulation path.

The strict stencil path (ops/stencils.py) evaluates the reference formulas
term-by-term each substep: at 96x48 a year spends ~35k substeps whose cost is
pure elementwise work — ~150 ops over the field per substep, dominated by the
masked polar sub-cycle.  But the circulation operator is LINEAR in the
transported field (reference src/greb.f90:556-915): every stencil
(7-point zonal diffusion :617-626, 2-point upwind advection :798-836,
meridional forms :585-590/:756-795, and the polar row stencils
:651-718/:842-906) has coefficients built only from time-constant geometry
(dxlat, kappa, wz) and the per-``ityr`` wind climatology.

This module therefore FOLDS each substep into

    x += sum_s C_s(ityr) * shift(x, s)          (11 shifts: lon +-1..3, lat +-1..2)
       + polar-band fix-up                       (clamped row iterations)

where C_s = const_s + mult_s * wind(ityr): the time-constant parts (wz
topography factors, 10/4/1 stencil weights, /3 and /20 normalizations,
row-dependent cc coefficients) live in ~25 precomputed constant fields
(build_const, ~1 MB at 96x48), and each step's C_s are assembled ON DEVICE
from them and the step's winds by step_coeffs (~30 multiply-adds, amortized
over the step's 24 substeps).  A substep is then ~11 fused multiply-adds
over the field instead of ~150 elementwise ops, with nothing per-step
stored or streamed — the same recipe works unchanged at refined grids.

Exactness: the folding is an algebraic regrouping of the reference float32
formulas (coefficients are accumulated in float64, cast to float32), so
results match the strict path to float32 rounding — the positivity clamps of
the polar sub-cycles (src/greb.f90:715, :907), which are the ONLY
nonlinearities, are kept exactly: the polar bands still iterate, on
statically-compacted row groups (rows needing k iterations form
prefixes/suffixes of the bands because dxlat shrinks monotonically toward
the poles, so every iteration level is a static slice).
Rows whose iteration count exceeds LOWRANK_N collapse into precomputed
composite operators (I+C)^n — dense and exact while they stay small,
SVD-truncated at refined grids where n reaches the thousands.

Not supported here (falls back to the strict path): legacy experiment
overrides of the transport (Experiment.circulation_off etc.), per-member
perturbation of transport parameters (kappa, z_air, z_vapor, u/v winds)
under vmap, and latitude-sharded execution (the band compaction needs the
full lat extent; sharded runners keep the strict masked form).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass
from ..grid import Grid
from . import stencils as stc

F32 = np.float32
F64 = np.float64

# lon shift order used by all packed 7-coefficient arrays
# (index: 0=m3, 1=m2, 2=m1, 3=centre, 4=p1, 5=p2, 6=p3)
_LON_IDX_SHIFT = ((0, 3), (1, 2), (2, 1), (4, -1), (5, -2), (6, -3))

# rows whose diffusion sub-cycle exceeds this iterate via the SVD-truncated
# composite; below it, explicit iteration is exact.  The explicit chains are
# latency-bound, so fold early (not yet tuned on the GPU).
LOWRANK_N = 8
# singular values below this fraction of the largest are truncated
LOWRANK_TOL = 3e-7


@dataclass(frozen=True)
class FastPlan:
    """Static structure of the fast path (python ints/tuples only)."""
    ydim: int
    xdim: int
    bt: int                      # top polar band rows [0, bt)
    bb: int                      # bottom polar band rows [Y-bb, Y)
    # extra iteration segments after the level-0 band iteration:
    # (rows_from_top_of_band, rows_from_bottom_of_band, n_iterations)
    diff_segs: Tuple[Tuple[int, int, int], ...]
    adv_segs: Tuple[Tuple[int, int, int], ...]
    # diffusion extra-iteration strategy (see build_tables):
    #   "dense"   — exact composite row operators (I+C)^(n-1), all rows with
    #               n>1; chosen while they stay small (96x48)
    #   "lowrank" — refined grids: rows with n > LOWRANK_N get an SVD-
    #               truncated composite (their spectrum collapses for large
    #               n); rows with 1 < n <= LOWRANK_N iterate explicitly
    #   "none"    — no composite rows
    comp_mode: str = "none"
    # band rows covered by the composite (prefix of the top band / suffix of
    # the bottom band)
    comp_kt: int = 0
    comp_kb: int = 0
    # EXTENSION grids: apply zonal advection to the zonally-DIFFUSED state
    # (sequential splitting) instead of adding both increments from the
    # same state.  The additive form's joint Fourier symbol is NOT a
    # contraction at deep-subcycled rows: the iterated advective increment
    # (1+s)^na - 1 rotates to magnitude ~1.5 before the per-iteration
    # upwind dissipation kills it (measured max|lambda| ~ 1.98 at 384x192
    # row 0 even at the 10 m/s design wind), while the sequential product
    # A*D is contractive because the deep diffusion annihilates exactly
    # the modes where the advective iterate rotates (decay exponent
    # ~ 17.6*kappa/(dt_crcl*u^2) >> 1 for practical winds).  Verified
    # numerically per-row at build time (grid.make_grid) and in
    # tests/test_extension_stability.py.  Reference-envelope grids keep
    # the reference's additive form (src/greb.f90:546-550) bit-for-bit.
    seq_zonal: bool = False

    @property
    def diff_composite(self) -> bool:
        return self.comp_mode != "none" and (self.comp_kt + self.comp_kb) > 0

    @property
    def nband(self) -> int:
        return self.bt + self.bb


# index maps for the packed constant arrays
# full (21, F, Y, X): constant coefficients + wind-multiplier fields; the
# per-step coefficient assembly is  coeff = const_part + multiplier * wind
_F_ZDC = slice(0, 6)     # zonal diffusion [m3,m2,m1,p1,p2,p3] (wz folded)
_F_C00 = 6               # constant centre (zonal-diff + merid-diff centres)
_F_MDC_KM1 = 7           # merid diffusion km1 coefficient
_F_MDC_KP1 = 8           # merid diffusion kp1 coefficient
_F_ZAM2, _F_ZAM1 = 9, 10          # x u_m -> zc[m2], zc[m1]
_F_ZAP1, _F_ZAP2 = 11, 12         # x u_p -> zc[p1], zc[p2]
_F_ZA0M, _F_ZA0P = 13, 14         # x u_m / u_p -> centre
_F_MAM2, _F_MAM1 = 15, 16         # x v_m -> mc[km2], mc[km1]
_F_MAP1, _F_MAP2 = 17, 18         # x v_p -> mc[kp1], mc[kp2]
_F_MA0M, _F_MA0P = 19, 20         # x v_m / v_p -> centre
N_FULL = 21
# band (16, F, B, X): polar-band constants
_B_PDC = slice(0, 7)     # polar diffusion row stencil [m3,m2,m1,c,p1,p2,p3]
_B_WZ = 7                # wz on the band (outer factor of dtx_diff)
_B_PAM3, _B_PAM2, _B_PAM1 = 8, 9, 10   # x u_m -> pac[m3,m2,m1]
_B_PA0M, _B_PA0P = 11, 12              # x u_m / u_p -> pac centre
_B_PAP1, _B_PAP2, _B_PAP3 = 13, 14, 15  # x u_p -> pac[p1,p2,p3]
N_BAND = 16


@pytree_dataclass
class FastConst:
    """Time-constant device arrays (small: ~25 field-sized constants; the
    per-step coefficients are assembled ON DEVICE from these + the step's
    winds by ``step_coeffs`` — nothing per-step is stored or streamed)."""
    full: jax.Array     # (21, F, Y, X) — see _F_* index map
    band: jax.Array     # (16, F, B, X) — see _B_* index map
    # composite of the diffusion extra iterations for the comp_kt top-prefix
    # + comp_kb bottom-suffix band rows (K = Kt+Kb):
    #   dense mode:   pcomp (F, K, X, X) = (I + C_fk)^(time2-1); pcu/pcw are
    #                 (F, 1, X, 1)/(F, 1, 1, X) placeholders
    #   lowrank mode: pcomp is a (F, 1, X, X) placeholder; pcu (F, K, X, r),
    #                 pcw (F, K, r, X) with P ~= pcu @ pcw (SVD-truncated)
    pcomp: jax.Array
    pcu: jax.Array
    pcw: jax.Array


@pytree_dataclass
class FastCoeffs:
    """One step's assembled coefficients (built on device by step_coeffs;
    constant across the step's 24 circulation substeps)."""
    zc: jax.Array   # (6, F, Y, X) lon-shift coefficients [m3,m2,m1,p1,p2,p3]
    c0: jax.Array   # (F, Y, X)    centre coefficient (all centre terms)
    mc: jax.Array   # (4, F, Y, X) lat-shift coefficients [km2,km1,kp1,kp2]
    pac: jax.Array  # (7, F, B, X) polar advection coefficients (centre at 3)


def step_coeffs(u: jax.Array, v: jax.Array, const: FastConst,
                plan: FastPlan) -> FastCoeffs:
    """Assemble one forcing step's folded coefficients from the constant
    fields and the step's (Y, X) winds — ~30 fused multiply-adds, amortized
    over the step's 24 substeps (reference wind sign splits:
    src/greb.f90:203-216)."""
    u_m = jnp.maximum(u, 0.0)
    u_p = jnp.minimum(u, 0.0)
    v_m = jnp.maximum(v, 0.0)
    v_p = jnp.minimum(v, 0.0)
    c = const.full
    zc = jnp.stack([
        c[0],
        c[1] + c[_F_ZAM2] * u_m,
        c[2] + c[_F_ZAM1] * u_m,
        c[3] + c[_F_ZAP1] * u_p,
        c[4] + c[_F_ZAP2] * u_p,
        c[5],
    ])
    c0 = (c[_F_C00] + c[_F_ZA0M] * u_m + c[_F_ZA0P] * u_p
          + c[_F_MA0M] * v_m + c[_F_MA0P] * v_p)
    mc = jnp.stack([
        c[_F_MAM2] * v_m,
        c[_F_MDC_KM1] + c[_F_MAM1] * v_m,
        c[_F_MDC_KP1] + c[_F_MAP1] * v_p,
        c[_F_MAP2] * v_p,
    ])
    Y, bt, bb = plan.ydim, plan.bt, plan.bb
    if plan.nband:
        ub_m = jnp.concatenate([u_m[..., :bt, :], u_m[..., Y - bb:, :]],
                               axis=-2)
        ub_p = jnp.concatenate([u_p[..., :bt, :], u_p[..., Y - bb:, :]],
                               axis=-2)
        b = const.band
        pac = jnp.stack([
            b[_B_PAM3] * ub_m,
            b[_B_PAM2] * ub_m,
            b[_B_PAM1] * ub_m,
            b[_B_PA0M] * ub_m + b[_B_PA0P] * ub_p,
            b[_B_PAP1] * ub_p,
            b[_B_PAP2] * ub_p,
            b[_B_PAP3] * ub_p,
        ])
    else:
        pac = jnp.zeros((7,) + const.band.shape[1:], jnp.float32)
    return FastCoeffs(zc=zc, c0=c0, mc=mc, pac=pac)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------
def build_composites(pdc64: np.ndarray, n_extra: np.ndarray, plan: "FastPlan",
                     F: int, B: int, X: int):
    """Dense or SVD-truncated composites (I + C_row)^n_extra of the polar
    diffusion row operator, for the comp_kt top-prefix + comp_kb
    bottom-suffix band rows.  pdc64: (7, F, B, X) float64 row coefficients
    (shifted-wz folded, no outer wz).  Shared by the v1 and v2 folds."""
    return _build_composites_impl(pdc64, n_extra, plan, F, B, X)


def composite_mats(pdc64: np.ndarray, n_extra: np.ndarray, ktc: int, kbc: int,
                   F: int, B: int, X: int):
    """Float64 composite operators (I + C_row)^n_extra for the ktc
    top-prefix + kbc bottom-suffix band rows.  Returns (rows_fb, {(f, b):
    (X, X) float64}).  Shared by the dense/lowrank forms (below) and the
    packed block-diagonal form (fastcirc2.build_packed_composites)."""
    rows_fb = ([(f, b) for f in range(F) for b in range(ktc)]
               + [(f, b) for f in range(F) for b in range(B - kbc, B)])
    jout = np.arange(X)
    pc64 = {}
    for f, b in rows_fb:
        C = np.zeros((X, X))
        C[jout, jout] += pdc64[3, f, b]
        for i, s in _LON_IDX_SHIFT:
            C[(jout - s) % X, jout] += pdc64[i, f, b]
        pc64[(f, b)] = np.linalg.matrix_power(
            np.eye(X) + C, int(n_extra[b]))
    return rows_fb, pc64


def _build_composites_impl(pdc64: np.ndarray, n_extra: np.ndarray,
                           plan: "FastPlan", F: int, B: int, X: int):
    pcomp = np.zeros((F, 1, X, X), F32)
    pcu = np.zeros((F, 1, X, 1), F32)
    pcw = np.zeros((F, 1, 1, X), F32)
    ktc, kbc = plan.comp_kt, plan.comp_kb
    K = ktc + kbc
    rows_fb, pc64 = composite_mats(pdc64, n_extra, ktc, kbc, F, B, X)
    if plan.comp_mode == "dense":
        pcomp = np.zeros((F, K, X, X))
        for f, b in rows_fb:
            k = b if b < ktc else K - (B - b)
            pcomp[f, k] = pc64[(f, b)]
        pcomp = pcomp.astype(F32)
    else:  # lowrank: P ~= (U S)[:, :r] @ Vt[:r]
        svds = {fb: np.linalg.svd(P) for fb, P in pc64.items()}
        rmax = 1
        for (uu, s, vt) in svds.values():
            rmax = max(rmax, int((s > LOWRANK_TOL * s[0]).sum()))
        pcu = np.zeros((F, K, X, rmax))
        pcw = np.zeros((F, K, rmax, X))
        for f, b in rows_fb:
            k = b if b < ktc else K - (B - b)
            uu, s, vt = svds[(f, b)]
            r = int((s > LOWRANK_TOL * s[0]).sum())
            pcu[f, k, :, :r] = uu[:, :r] * s[:r]
            pcw[f, k, :r, :] = vt[:r]
        pcu = pcu.astype(F32)
        pcw = pcw.astype(F32)
    return pcomp, pcu, pcw


def _segments(time2_band_top: np.ndarray, time2_band_bot: np.ndarray,
              off_t: int = 0, off_b: int = 0):
    """Extra-iteration segments after the uniform level-0 iteration.

    Rows with time2=k iterate k-1 more times; since time2 is monotone
    non-increasing away from each pole, the iterating rows form a prefix of
    the top band / suffix of the bottom band — shifted inward by
    ``off_t``/``off_b`` when the outermost rows are handled by the composite
    operator instead.  Returned counts are relative to those offsets."""
    top = time2_band_top[off_t:]
    bot = time2_band_bot[:len(time2_band_bot) - off_b]
    vals = sorted(set(np.concatenate([top, bot]).tolist()))
    segs = []
    prev = 1
    for v in vals:
        if v <= 1:
            continue
        kt = int((top >= v).sum())
        kb = int((bot >= v).sum())
        # monotonicity guarantee (prefix/suffix form after the offsets)
        assert (top[:kt] >= v).all() and (top[kt:] < v).all()
        assert (bot[len(bot) - kb:] >= v).all()
        segs.append((kt, kb, int(v - prev)))
        prev = v
    return tuple(segs)


def make_plan(grid: Grid) -> FastPlan:
    polar = np.asarray(grid.polar_rows, bool)
    R = grid.ydim
    if polar.all():
        # refined grids: dxlat < 2.5e5 m everywhere, so the whole field is
        # "polar"; split into hemispheres so time2 is monotone per band
        bt = R // 2
        bb = R - bt
    elif polar.any():
        bt = int(np.argmin(polar))
        bb = int(np.argmin(polar[::-1]))
        ok = (polar[:bt].all() and polar[R - bb:].all()
              and not polar[bt:R - bb].any())
        if not ok:
            raise ValueError("fast path requires contiguous polar bands")
    else:
        bt = bb = 0
    d2, a2 = grid.diff_sched.time2, grid.adv_sched.time2
    top = slice(0, bt)
    bot = slice(R - bb, R)

    # composite strategy: dense while all n>1 rows stay small (<= 4 MiB),
    # else SVD-truncated composites for the huge-n rows only ((I+C)^n has a
    # collapsed spectrum for large n; moderate-n rows iterate explicitly)
    if bt + bb == 0 or not (np.concatenate([d2[top], d2[bot]]) > 1).any():
        mode, thr = "none", 1
    else:
        k_all = int((d2[top] > 1).sum()) + int((d2[bot] > 1).sum())
        if 2 * k_all * grid.xdim * grid.xdim * 4 <= 4 * 2 ** 20:
            mode, thr = "dense", 1
        else:
            mode, thr = "lowrank", LOWRANK_N
    comp_kt = int((d2[top] > thr).sum()) if mode != "none" else 0
    comp_kb = int((d2[bot] > thr).sum()) if mode != "none" else 0
    # rows in the composite do only level 0 explicitly; the remaining
    # iterating rows sit just inside them (offsets comp_kt/comp_kb)
    return FastPlan(
        ydim=R, xdim=grid.xdim, bt=bt, bb=bb,
        diff_segs=(_segments(d2[top], d2[bot], comp_kt, comp_kb)
                   if bt + bb else ()),
        adv_segs=_segments(a2[top], a2[bot]) if bt + bb else (),
        comp_mode=mode, comp_kt=comp_kt, comp_kb=comp_kb,
        seq_zonal=bool(grid.extension_mode),
    )


def _np_lon_shifts(a: np.ndarray):
    """dict s -> a rolled so that result[j] = a[j+s] (s>0 looks east).
    Matches stencils.lon_shifts: m1 = roll(+1) = value at j-1."""
    r = lambda s: np.roll(a, s, axis=-1)
    return {"m3": r(3), "m2": r(2), "m1": r(1), "c": a,
            "p1": r(-1), "p2": r(-2), "p3": r(-3)}


def _np_lat_shift(a: np.ndarray, s: int) -> np.ndarray:
    """Zero-halo lat shift: result[..., k, :] = a[..., k+s, :] (0 outside).
    s=-1 gives the value at the row equatorward... strictly: km1 (k-1)."""
    out = np.zeros_like(a)
    if s > 0:
        out[..., :-s, :] = a[..., s:, :]
    elif s < 0:
        out[..., -s:, :] = a[..., :s, :]
    else:
        out = a.copy()
    return out


def build_const(wz_air: np.ndarray, wz_vapor: np.ndarray, grid: Grid,
                st: stc.StencilStatic, kappa: float,
                plan: Optional[FastPlan] = None,
                include_advection: bool = True,
                ) -> Tuple[FastPlan, FastConst]:
    """Precompute the constant coefficient fields (float64, cast float32).

    Per-step coefficients are assembled on device by ``step_coeffs`` from
    these constants and the step's winds; nothing per-step is stored.
    ``include_advection=False`` zeroes the advective multipliers (legacy
    log_exp 8 vapor-diffusion-only)."""
    if grid.extension_mode:
        # the v1 fold assembles advection INTO the shared zc coefficient
        # planes (step_coeffs), which cannot express the sequential zonal
        # splitting extension grids require (FastPlan.seq_zonal)
        raise ValueError("fastcirc v1 does not support extension-mode "
                         "grids; use fastcirc_version=2 (ops/fastcirc2)")
    if plan is None:
        plan = make_plan(grid)
    Y, X = plan.ydim, plan.xdim
    wz2 = np.stack([np.asarray(wz_air, F64), np.asarray(wz_vapor, F64)])
    F = wz2.shape[0]

    w = _np_lon_shifts(wz2)                    # (F,Y,X) each
    col = lambda a: np.asarray(a, F64).reshape(Y, 1)
    dtc = F64(F32(st.dt_crcl))
    kap = F64(F32(kappa))
    dyy = F64(F32(st.dyy))
    polar = np.asarray(grid.polar_rows, bool).reshape(Y, 1)
    mid = (~polar).astype(F64)
    adv = 1.0 if include_advection else 0.0

    full = np.zeros((N_FULL, F, Y, X))
    # --- zonal diffusion (mid rows), cc = kappa*dtc/dxlat^2, outer wz ------
    ccm = kap * dtc / col(grid.dxlat.astype(F64) ** 2) / 20.0 * mid
    full[0] = ccm * w["m3"] * wz2
    full[1] = ccm * (3.0 * w["m2"] - w["m3"]) * wz2
    full[2] = ccm * (6.0 * w["m1"] - 3.0 * w["m2"]) * wz2
    full[3] = ccm * (6.0 * w["p1"] - 3.0 * w["p2"]) * wz2
    full[4] = ccm * (3.0 * w["p2"] - w["p3"]) * wz2
    full[5] = ccm * w["p3"] * wz2
    zdc0 = ccm * (-6.0 * (w["m1"] + w["p1"])) * wz2

    # --- meridional diffusion (all rows), outer wz -------------------------
    ccy = kap * dtc / dyy ** 2
    wzm1 = _np_lat_shift(wz2, -1)   # value at row k-1 (0 at pole edge)
    wzm2 = _np_lat_shift(wz2, -2)
    wzp1 = _np_lat_shift(wz2, 1)
    wzp2 = _np_lat_shift(wz2, 2)
    full[_F_MDC_KM1] = ccy * wzm1 * wz2
    full[_F_MDC_KP1] = ccy * wzp1 * wz2
    full[_F_C00] = zdc0 - ccy * (wzm1 + wzp1) * wz2

    # --- zonal advection multipliers (mid rows), cc = dtc/dxlat/2, no wz ---
    cax = col(np.asarray(grid.ccx_adv, F64)) * mid / 3.0 * adv
    full[_F_ZAM2] = cax * w["m2"]
    full[_F_ZAM1] = cax * w["m1"]
    full[_F_ZAP1] = -cax * w["p1"]
    full[_F_ZAP2] = -cax * w["p2"]
    full[_F_ZA0M] = -cax * (w["m1"] + w["m2"])
    full[_F_ZA0P] = cax * (w["p1"] + w["p2"])

    # --- meridional advection multipliers (all rows) -----------------------
    ccy2 = dtc / dyy / 2.0 * adv
    rows = np.arange(Y).reshape(Y, 1)
    am = np.where(rows == 1, ccy2, ccy2 / 3.0)
    ap = np.where(rows == Y - 2, ccy2, ccy2 / 3.0)
    full[_F_MAM2] = am * wzm2
    full[_F_MAM1] = am * wzm1
    full[_F_MAP1] = -ap * wzp1
    full[_F_MAP2] = -ap * wzp2
    full[_F_MA0M] = -am * (wzm1 + wzm2)
    full[_F_MA0P] = ap * (wzp1 + wzp2)

    # --- polar bands --------------------------------------------------------
    B = plan.nband
    if B:
        bidx = np.r_[np.arange(plan.bt), np.arange(Y - plan.bb, Y)]
        wb = {k: a[..., bidx, :] for k, a in w.items()}          # (F,B,X)
        band = np.zeros((N_BAND, F, B, X))
        band[_B_WZ] = wz2[:, bidx, :]
        # polar diffusion: diff7 with cc2 = kappa*dtdff2/dxlat^2 (constant)
        cc2 = (kap * np.asarray(grid.diff_sched.dtdff2, F64)[bidx].reshape(B, 1)
               / (np.asarray(grid.dxlat, F64)[bidx].reshape(B, 1) ** 2)) / 20.0
        band[0] = cc2 * wb["m3"]
        band[1] = cc2 * (3.0 * wb["m2"] - wb["m3"])
        band[2] = cc2 * (6.0 * wb["m1"] - 3.0 * wb["m2"])
        band[3] = cc2 * (-6.0 * (wb["m1"] + wb["p1"]))
        band[4] = cc2 * (6.0 * wb["p1"] - 3.0 * wb["p2"])
        band[5] = cc2 * (3.0 * wb["p2"] - wb["p3"])
        band[6] = cc2 * wb["p3"]
        pdc64 = band[_B_PDC]

        # polar advection (smooth3) multipliers, cc = adv ccx2, incl. the
        # src/greb.f90:881 jp2 quirk column
        ca = (np.asarray(grid.adv_sched.ccx2, F64)[bidx].reshape(B, 1)
              / 20.0 * adv)
        if st.quirk_jp2:
            qcol = (np.arange(X) == X - 3)            # Fortran j = xdim-2
            wp2q = np.where(qcol, wb["p1"], wb["p2"])
        else:
            qcol = np.zeros(X, bool)
            wp2q = wb["p2"]
        band[_B_PAM1] = ca * (10.0 * wb["m1"] - 4.0 * wb["m2"])
        band[_B_PAM2] = ca * (4.0 * wb["m2"] - wb["m3"])
        band[_B_PAM3] = ca * wb["m3"]
        pp1 = ca * (-10.0 * wb["p1"] + 4.0 * wp2q)
        pp2q = ca * (-4.0 * wp2q + wb["p3"])
        # the p2q term reads the p1 neighbour at the quirk column
        band[_B_PAP1] = pp1 + np.where(qcol, pp2q, 0.0)
        band[_B_PAP2] = np.where(qcol, 0.0, pp2q)
        band[_B_PAP3] = -ca * wb["p3"]
        band[_B_PA0M] = -10.0 * ca * wb["m1"]
        band[_B_PA0P] = 10.0 * ca * wb["p1"]

        # composite of the extra diffusion iterations (see FastConst)
        if plan.diff_composite:
            n_extra = np.asarray(grid.diff_sched.time2)[bidx] - 1
            pcomp, pcu, pcw = build_composites(pdc64, n_extra, plan, F, B, X)
        else:
            pcomp = np.zeros((F, 1, X, X), F32)
            pcu = np.zeros((F, 1, X, 1), F32)
            pcw = np.zeros((F, 1, 1, X), F32)
    else:
        band = np.zeros((N_BAND, F, 1, X))
        pcomp = np.zeros((F, 1, X, X), F32)
        pcu = np.zeros((F, 1, X, 1), F32)
        pcw = np.zeros((F, 1, 1, X), F32)

    const = FastConst(full=jnp.asarray(full.astype(F32)),
                      band=jnp.asarray(band.astype(F32)),
                      pcomp=jnp.asarray(pcomp), pcu=jnp.asarray(pcu),
                      pcw=jnp.asarray(pcw))
    return plan, const


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------
def _apply7(t: jax.Array, coef: jax.Array) -> jax.Array:
    """sum_s coef[s]*roll(t, s) over [m3,m2,m1,c,p1,p2,p3]."""
    d = coef[3] * t
    for i, s in _LON_IDX_SHIFT:
        d = d + coef[i] * jnp.roll(t, s, axis=-1)
    return d


def _clamped(d: jax.Array, t: jax.Array) -> jax.Array:
    """Positivity clamp of the polar sub-cycles (src/greb.f90:715, :907)."""
    return jnp.where(d <= -t, -0.9 * t, d)


def _iterate(seg: jax.Array, cseg: jax.Array, iters: int) -> jax.Array:
    one = lambda s: s + _clamped(_apply7(s, cseg), s)
    if iters <= 16:
        for _ in range(iters):
            seg = one(seg)
        return seg
    return jax.lax.fori_loop(0, iters, lambda i, s: one(s), seg)


def _apply7_rolled(rolls, t: jax.Array, coef: jax.Array) -> jax.Array:
    """_apply7 with the lon rolls of t precomputed (shared between the
    diffusion and advection band stencils)."""
    d = coef[3] * t
    for (i, _), r in zip(_LON_IDX_SHIFT, rolls):
        d = d + coef[i] * r
    return d


def _band_increment(xb: jax.Array, coef: jax.Array, segs, B: int,
                    rolls=None, off_t: int = 0, off_b: int = 0) -> jax.Array:
    """Level-0 clamped iteration on the whole band + extra segment
    iterations; returns (t_final - xb).  coef is (7,F,B,X) (or any
    broadcastable batch).

    The top/bottom segment slabs iterate SEPARATELY: each is a contiguous
    prefix/suffix static slice; a combined 2-row gather would force a
    strided-sublane relayout on every iteration (measured 20 us/step at
    96x48 — more than the rest of the substep combined)."""
    d0 = (_apply7(xb, coef) if rolls is None
          else _apply7_rolled(rolls, xb, coef))
    d0 = _clamped(d0, xb)
    t1 = xb + d0
    for kt, kb, iters in segs:
        t0, t1e = off_t, off_t + kt
        b0, b1e = B - off_b - kb, B - off_b
        top = (_iterate(t1[..., t0:t1e, :], coef[..., t0:t1e, :], iters)
               if kt else None)
        bot = (_iterate(t1[..., b0:b1e, :], coef[..., b0:b1e, :], iters)
               if kb else None)
        parts = [t1[..., :t0, :] if t0 else None,
                 top,
                 t1[..., t1e:b0, :],
                 bot,
                 t1[..., b1e:, :] if off_b else None]
        parts = [s for s in parts if s is not None and s.shape[-2]]
        t1 = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-2)
    return t1 - xb



def _apply_composite(t1: jax.Array, const: FastConst,
                     plan: FastPlan) -> jax.Array:
    """Apply the precomputed extra-iteration composite to the band.

    Only the comp_kt top / comp_kb bottom band rows change; the rest pass
    through.  An unbatched band applies each row's operator as a plain
    2-D dot; batched bands (leading member dims) use one batched einsum."""
    F, B, X = t1.shape[-3], t1.shape[-2], t1.shape[-1]
    ktc, kbc = plan.comp_kt, plan.comp_kb
    if ktc + kbc == 0:
        return t1
    lowrank = plan.comp_mode == "lowrank"
    if t1.ndim > 3:
        sel = jnp.concatenate([t1[..., :ktc, :], t1[..., B - kbc:, :]],
                              axis=-2)
        if lowrank:
            z = jnp.einsum('...fkx,fkxr->...fkr', sel, const.pcu,
                           preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
            y = jnp.einsum('...fkr,fkrx->...fkx', z, const.pcw,
                           preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        else:
            y = jnp.einsum('...fkx,fkxy->...fky', sel, const.pcomp,
                           preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        return jnp.concatenate([y[..., :ktc, :], t1[..., ktc:B - kbc, :],
                                y[..., ktc:, :]], axis=-2)

    def _row(tf_row, f, k):
        # (1, X) @ composite — plain 2-D dots
        if lowrank:
            z = jnp.dot(tf_row, const.pcu[f, k],
                        preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
            return jnp.dot(z, const.pcw[f, k],
                           preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        return jnp.dot(tf_row, const.pcomp[f, k],
                       preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)

    bands = []
    for f in range(F):
        tf = t1[f]                                   # (B, X)
        parts = []
        for k in range(ktc):
            parts.append(_row(tf[k:k + 1, :], f, k))
        mid = tf[ktc:B - kbc, :]
        if mid.shape[0]:
            parts.append(mid)
        for k in range(kbc):
            parts.append(_row(tf[B - kbc + k:B - kbc + k + 1, :], f, ktc + k))
        bands.append(jnp.concatenate(parts, axis=0) if len(parts) > 1
                     else parts[0])
    return jnp.stack(bands, axis=0)


def substep(x: jax.Array, cf: FastCoeffs, const: FastConst,
            plan: FastPlan) -> jax.Array:
    """One dt_crcl circulation substep on the (…, F, Y, X) stacked field."""
    Y = plan.ydim
    # linear pass: zonal (mid rows) + meridional (all rows)
    dx = cf.c0 * x
    for i, s in ((0, 3), (1, 2), (2, 1), (3, -1), (4, -2), (5, -3)):
        dx = dx + cf.zc[i] * jnp.roll(x, s, axis=-1)
    pad = [(0, 0)] * (x.ndim - 2) + [(2, 2), (0, 0)]
    xe = jnp.pad(x, pad)
    dx = dx + cf.mc[0] * xe[..., 0:Y, :]        # km2
    dx = dx + cf.mc[1] * xe[..., 1:Y + 1, :]    # km1
    dx = dx + cf.mc[2] * xe[..., 3:Y + 3, :]    # kp1
    dx = dx + cf.mc[3] * xe[..., 4:Y + 4, :]    # kp2

    # polar band fix-up (zonal part on the bands; clamped iterations)
    if plan.nband:
        B, bt, bb = plan.nband, plan.bt, plan.bb
        xb = jnp.concatenate([x[..., :bt, :], x[..., Y - bb:, :]], axis=-2)
        dtxd = _band_increment(xb, const.band[_B_PDC], plan.diff_segs, B,
                               off_t=plan.comp_kt, off_b=plan.comp_kb)
        if plan.diff_composite:
            t1 = xb + dtxd
            t2 = _apply_composite(t1, const, plan)
            t1 = t1 + _clamped(t2 - t1, t1)
            dtxd = t1 - xb
        dtxa = _band_increment(xb, cf.pac, plan.adv_segs, B)
        bdx = const.band[_B_WZ] * dtxd + dtxa
        # static-slice concatenation
        dx = jnp.concatenate([
            dx[..., :bt, :] + bdx[..., :bt, :],
            dx[..., bt:Y - bb, :],
            dx[..., Y - bb:, :] + bdx[..., bt:, :],
        ], axis=-2)
    return x + dx


def circulation(x: jax.Array, cf: FastCoeffs, const: FastConst,
                plan: FastPlan, nsub: int, unroll=False) -> jax.Array:
    """Sub-cycled circulation increment over one 12-h step (fast path).
    Same contract as stencils.circulation: returns the total increment."""
    step = lambda xc: substep(xc, cf, const, plan)
    if unroll is True:
        xc = x
        for _ in range(nsub):
            xc = step(xc)
    elif isinstance(unroll, int) and 1 < unroll <= nsub and nsub % unroll == 0:
        def block(i, xc):
            for _ in range(unroll):
                xc = step(xc)
            return xc
        xc = jax.lax.fori_loop(0, nsub // unroll, block, x)
    else:
        xc = jax.lax.fori_loop(0, nsub, lambda i, xc: step(xc), x)
    return xc - x
