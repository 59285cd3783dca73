"""Uniform coefficient-folded circulation (v2 of ops/fastcirc.py).

The v1 fold (ops/fastcirc.py) treats the polar bands as a SEPARATE compute
path: the band rows are gathered into a (F, B, X) slab and run their own
7-point applies, clamps, and composites.  At 96x48 that band work is ~45
small vector ops per substep, each paying a fixed per-op overhead
regardless of its size.

This module folds the polar-band zonal stencils into the SAME full-field
apply as the interior rows.  The key observations (reference
src/greb.f90:556-915):

* interior and polar zonal diffusion use the SAME 10/4/1 smoothed 7-point
  form; only the per-row coefficient differs (ccx = kappa*dt_crcl/dxlat^2
  interior, ccx2 = kappa*dtdff2/dxlat^2 polar, src/greb.f90:582 vs :654) —
  so one (7, F, Y, X) coefficient stack covers every row;
* interior (2-point upwind /3, :798-836) and polar (10/4/1 smooth3, :842-906)
  zonal advection are both linear in the transported field with reach <= 3,
  so one wind-multiplied (7, F, Y, X) stack covers every row too;
* the positivity clamps (:715, :907) apply only on polar rows — a masked
  `where` on the full-field increment reproduces them exactly;
* the outer wz of dX_diffuse = wz*(dTx+dTy) (:721) multiplies AFTER the
  clamp, so zonal-diffusion coefficients carry NO outer wz (for any row)
  and the substep applies `wz * dd` once.

A substep is then ~35 large vector ops (6 shared lon rolls, two 7-point
applies, two masked clamps, one merged meridional apply, one combine)
instead of ~18 large + ~45 small — and, because every op is a full-field
op with per-row coefficient FIELDS, the identical program runs on a
latitude shard: rolls are lon-local, the meridional pass takes a
caller-supplied halo extension, masks/coefficients shard like the state.

Extra sub-cycle iterations (rows where the CFL count time2 > 1) follow the
v1 strategy: prefix/suffix row slices iterate explicitly, and rows with
huge counts collapse into precomputed dense or SVD-truncated composite
operators (exact modulo the in-iteration clamp, which is checked once
against the composite result — see fastcirc.py docstring).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass, static_field
from ..grid import Grid
from . import fastcirc as v1
from . import stencils as stc

F32 = np.float32
F64 = np.float64

FastPlan = v1.FastPlan          # same static structure
_LON_IDX_SHIFT = v1._LON_IDX_SHIFT

# zam multiplier index map (x u_m for 0..3, x u_p for 4..7)
_ZA_M3, _ZA_M2, _ZA_M1, _ZA_CM = 0, 1, 2, 3
_ZA_CP, _ZA_P1, _ZA_P2, _ZA_P3 = 4, 5, 6, 7
# mer index map
_MD_KM1, _MD_KP1, _C0_MD = 0, 1, 2
_MAM2, _MAM1, _MAP1, _MAP2, _MA0M, _MA0P = 3, 4, 5, 6, 7, 8


@pytree_dataclass
class Fast2Const:
    """Time-constant device arrays of the uniform fold."""
    zd: jax.Array       # (7, F, Y, X) zonal diffusion [m3,m2,m1,c,p1,p2,p3]
    zam: jax.Array      # (8, F, Y, X) zonal advection wind multipliers
    mer: jax.Array      # (9, F, Y, X) meridional constants/multipliers
    wz: jax.Array       # (F, Y, X) outer diffusion weight
    band: jax.Array     # (Y, 1) bool — rows whose zonal increments clamp
    pcomp: jax.Array    # composites, as in v1.FastConst
    pcu: jax.Array      # lowrank: (F, K, X, r);  PACKED: (X, Rtot) U_all
    pcw: jax.Array      # lowrank: (F, K, r, X);  PACKED: (Rtot, X) W_all
    # PACKED composites only ("packed" comp_mode): (F*K, Rtot) 0/1 block-
    # diagonal mask — block b = (f*K + k) owns the column range of its own
    # SVD factors, so   t2 = ((T @ pcu) * pmask) @ pcw   computes every
    # row's composite in TWO plain 2-D matmuls (per-row ADAPTIVE ranks
    # concatenate along Rtot with no padding waste).
    # Zero-masked cross terms contribute exact f32 zeros.
    pmask: jax.Array = None


# number of (Y, X) coefficient planes per transported field in Fast2Const
# (zd + zam + mer + wz) — memory accounting derives from this, so it can't
# silently drift if the fold changes
N_COEF_PLANES = 7 + 8 + 9 + 1


@pytree_dataclass
class Fast2Coeffs:
    """One step's assembled coefficients (member-independent)."""
    za: jax.Array       # (7, F, Y, X) zonal advection [m3,m2,m1,c,p1,p2,p3]
    mc: jax.Array       # (4, F, Y, X) meridional [km2,km1,kp1,kp2]
    c0m: jax.Array      # (F, Y, X) meridional centre


def step_coeffs(u: jax.Array, v: jax.Array, const: Fast2Const,
                plan: FastPlan) -> Fast2Coeffs:
    """Assemble one forcing step's wind-dependent coefficients
    (sign splits per src/greb.f90:203-216)."""
    u_m = jnp.maximum(u, 0.0)
    u_p = jnp.minimum(u, 0.0)
    v_m = jnp.maximum(v, 0.0)
    v_p = jnp.minimum(v, 0.0)
    a = const.zam
    za = jnp.stack([
        a[_ZA_M3] * u_m,
        a[_ZA_M2] * u_m,
        a[_ZA_M1] * u_m,
        a[_ZA_CM] * u_m + a[_ZA_CP] * u_p,
        a[_ZA_P1] * u_p,
        a[_ZA_P2] * u_p,
        a[_ZA_P3] * u_p,
    ])
    m = const.mer
    mc = jnp.stack([
        m[_MAM2] * v_m,
        m[_MD_KM1] + m[_MAM1] * v_m,
        m[_MD_KP1] + m[_MAP1] * v_p,
        m[_MAP2] * v_p,
    ])
    c0m = m[_C0_MD] + m[_MA0M] * v_m + m[_MA0P] * v_p
    return Fast2Coeffs(za=za, mc=mc, c0m=c0m)


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------
def build_packed_composites(pdc64: np.ndarray, n_extra: np.ndarray,
                            ktc: int, kbc: int, F: int, B: int, X: int,
                            tol: float = v1.LOWRANK_TOL):
    """Block-diagonal PACKED SVD composites: per-(field,row) adaptive-rank
    factors concatenated along one axis, so the whole composite block
    applies as two plain 2-D matmuls plus a 0/1 mask (see Fast2Const.pmask).
    Replaces the per-row lowrank loop (56 small dots/substep at 384x192)
    with two large matmuls.

    Returns (U_all (X, Rtot) f32, W_all (Rtot, X) f32, mask (F*K, Rtot))."""
    rows_fb, pc64 = v1.composite_mats(pdc64, n_extra, ktc, kbc, F, B, X)
    K = ktc + kbc
    # block order matches the apply's reshape (..., F, K, X) -> (F*K, X):
    # f-major, top-prefix rows then bottom-suffix rows
    ublocks, wblocks, ranks = [], [], []
    for f in range(F):
        for k in range(K):
            b = k if k < ktc else B - K + k
            uu, s, vt = np.linalg.svd(pc64[(f, b)])
            r = max(1, int((s > tol * s[0]).sum()))
            ublocks.append(uu[:, :r] * s[:r])
            wblocks.append(vt[:r])
            ranks.append(r)
    rtot = sum(ranks)
    u_all = np.concatenate(ublocks, axis=1).astype(F32)        # (X, Rtot)
    w_all = np.concatenate(wblocks, axis=0).astype(F32)        # (Rtot, X)
    mask = np.zeros((F * K, rtot), F32)
    off = 0
    for i, r in enumerate(ranks):
        mask[i, off:off + r] = 1.0
        off += r
    return u_all, w_all, mask


def _zonal_diffusion64(wz_air: np.ndarray, wz_vapor: np.ndarray,
                       grid: Grid, st: stc.StencilStatic,
                       kappa: float) -> np.ndarray:
    """(7, F, Y, X) float64 zonal-diffusion coefficients, one per row and
    no outer wz.  Interior rows: cc = kappa*dt_crcl/dxlat^2
    (src/greb.f90:582); polar rows: cc = kappa*dtdff2/dxlat^2 (:654).

    Each point's seven coefficients sum to zero, so the operator conserves
    the zonal mean.  Composite powers (I+C)^n must be built from these
    float64 values: float32 rounding breaks the zero sum, and n in the
    thousands turns that into a drift of the mean of order n * 1e-8."""
    wz2 = np.stack([np.asarray(wz_air, F64), np.asarray(wz_vapor, F64)])
    w = v1._np_lon_shifts(wz2)
    Y = grid.ydim
    col = lambda a: np.asarray(a, F64).reshape(Y, 1)
    kap = F64(F32(kappa))
    polar = np.asarray(grid.polar_rows, bool).reshape(Y, 1)
    cc_in = kap * F64(F32(st.dt_crcl)) / col(grid.dxlat.astype(F64) ** 2)
    cc_po = kap * col(grid.diff_sched.dtdff2) / col(grid.dxlat.astype(F64) ** 2)
    ccd = np.where(polar, cc_po, cc_in) / 20.0
    return np.stack([
        ccd * w["m3"],
        ccd * (3.0 * w["m2"] - w["m3"]),
        ccd * (6.0 * w["m1"] - 3.0 * w["m2"]),
        ccd * (-6.0 * (w["m1"] + w["p1"])),
        ccd * (6.0 * w["p1"] - 3.0 * w["p2"]),
        ccd * (3.0 * w["p2"] - w["p3"]),
        ccd * w["p3"],
    ])


def build_const(wz_air: np.ndarray, wz_vapor: np.ndarray, grid: Grid,
                st: stc.StencilStatic, kappa: float,
                plan: Optional[FastPlan] = None,
                include_advection: bool = True,
                with_composites: bool = True,
                ) -> Tuple[FastPlan, Fast2Const]:
    """Precompute the uniform constant coefficient fields (float64 builds,
    float32 results), algebraically regrouping the reference formulas
    exactly like v1.build_const but WITHOUT a separate band path."""
    if plan is None:
        plan = v1.make_plan(grid)
    Y, X = plan.ydim, plan.xdim
    wz2 = np.stack([np.asarray(wz_air, F64), np.asarray(wz_vapor, F64)])
    F = wz2.shape[0]

    w = v1._np_lon_shifts(wz2)
    col = lambda a: np.asarray(a, F64).reshape(Y, 1)
    dtc = F64(F32(st.dt_crcl))
    kap = F64(F32(kappa))
    dyy = F64(F32(st.dyy))
    polar = np.asarray(grid.polar_rows, bool).reshape(Y, 1)
    adv = 1.0 if include_advection else 0.0

    zd = _zonal_diffusion64(wz_air, wz_vapor, grid, st, kappa)

    # --- zonal advection wind multipliers -----------------------------------
    # interior rows: 2-point upwind /3 (src/greb.f90:798-836)
    cax = col(np.asarray(grid.ccx_adv, F64)) / 3.0 * adv
    # polar rows: 10/4/1 smooth3 /20 with static ccx2 (:842-906) + jp2 quirk
    ca = col(grid.adv_sched.ccx2) / 20.0 * adv
    if st.quirk_jp2:
        qcol = (np.arange(X) == X - 3)              # Fortran j = xdim-2 (:881)
        wp2q = np.where(qcol, w["p1"], w["p2"])
    else:
        qcol = np.zeros(X, bool)
        wp2q = w["p2"]
    pp1 = ca * (-10.0 * w["p1"] + 4.0 * wp2q)
    pp2q = ca * (-4.0 * wp2q + w["p3"])
    zam = np.zeros((8, F, Y, X))
    zam[_ZA_M3] = np.where(polar, ca * w["m3"], 0.0)
    zam[_ZA_M2] = np.where(polar, ca * (4.0 * w["m2"] - w["m3"]), cax * w["m2"])
    zam[_ZA_M1] = np.where(polar, ca * (10.0 * w["m1"] - 4.0 * w["m2"]),
                           cax * w["m1"])
    zam[_ZA_CM] = np.where(polar, -10.0 * ca * w["m1"],
                           -cax * (w["m1"] + w["m2"]))
    zam[_ZA_CP] = np.where(polar, 10.0 * ca * w["p1"],
                           cax * (w["p1"] + w["p2"]))
    zam[_ZA_P1] = np.where(polar, pp1 + np.where(qcol, pp2q, 0.0),
                           -cax * w["p1"])
    zam[_ZA_P2] = np.where(polar, np.where(qcol, 0.0, pp2q), -cax * w["p2"])
    zam[_ZA_P3] = np.where(polar, -ca * w["p3"], 0.0)

    # --- meridional (identical to v1; diffusion parts carry the outer wz) ---
    ccy = kap * dtc / dyy ** 2
    wzm1 = v1._np_lat_shift(wz2, -1)
    wzm2 = v1._np_lat_shift(wz2, -2)
    wzp1 = v1._np_lat_shift(wz2, 1)
    wzp2 = v1._np_lat_shift(wz2, 2)
    ccy2 = dtc / dyy / 2.0 * adv
    rows = np.arange(Y).reshape(Y, 1)
    am = np.where(rows == 1, ccy2, ccy2 / 3.0)
    ap = np.where(rows == Y - 2, ccy2, ccy2 / 3.0)
    mer = np.zeros((9, F, Y, X))
    mer[_MD_KM1] = ccy * wzm1 * wz2
    mer[_MD_KP1] = ccy * wzp1 * wz2
    mer[_C0_MD] = -ccy * (wzm1 + wzp1) * wz2
    mer[_MAM2] = am * wzm2
    mer[_MAM1] = am * wzm1
    mer[_MAP1] = -ap * wzp1
    mer[_MAP2] = -ap * wzp2
    mer[_MA0M] = -am * (wzm1 + wzm2)
    mer[_MA0P] = ap * (wzp1 + wzp2)

    # --- composites of the extra diffusion iterations ------------------------
    import dataclasses
    B = plan.nband
    pcomp = np.zeros((1, 1, 1, 1), F32)
    pcu = np.zeros((1, 1, 1, 1), F32)
    pcw = np.zeros((1, 1, 1, 1), F32)
    pmask = np.zeros((1, 1), F32)
    if B and plan.diff_composite and with_composites:
        bidx = np.r_[np.arange(plan.bt), np.arange(Y - plan.bb, Y)]
        pdc64 = zd[:, :, bidx, :]                   # (7, F, B, X)
        n_extra = np.asarray(grid.diff_sched.time2)[bidx] - 1
        if plan.comp_mode == "lowrank":
            pcu, pcw, pmask = build_packed_composites(
                pdc64, n_extra, plan.comp_kt, plan.comp_kb, F, B, X)
            plan = dataclasses.replace(plan, comp_mode="packed")
        else:
            pcomp, pcu, pcw = v1.build_composites(pdc64, n_extra, plan,
                                                  F, B, X)
    elif not with_composites:
        # caller builds its own composites (build_sharded) — skip the SVD
        # pass, the dominant build cost at refined grids
        plan = dataclasses.replace(plan, comp_mode="none",
                                   comp_kt=0, comp_kb=0)

    band = np.zeros((Y, 1), bool)
    band[:plan.bt] = True
    if plan.bb:
        band[Y - plan.bb:] = True

    const = Fast2Const(
        zd=jnp.asarray(zd.astype(F32)), zam=jnp.asarray(zam.astype(F32)),
        mer=jnp.asarray(mer.astype(F32)),
        wz=jnp.asarray(wz2.astype(F32)), band=jnp.asarray(band),
        pcomp=jnp.asarray(pcomp), pcu=jnp.asarray(pcu), pcw=jnp.asarray(pcw),
        pmask=jnp.asarray(pmask))
    return plan, const


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------
def _apply7_rolled(rolls, x, coef):
    """sum_s coef[s] * roll(x, s) with the 6 rolls precomputed/shared.

    Balanced-tree accumulation: the substep is latency-bound on this chain
    at small grids, so a depth-3 tree beats the depth-7 sequential sum."""
    terms = [coef[3] * x] + [coef[i] * r
                             for (i, _), r in zip(_LON_IDX_SHIFT, rolls)]
    while len(terms) > 1:
        nxt = [terms[k] + terms[k + 1] for k in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _masked_clamp(d, x, band):
    """Positivity clamp on band rows only (src/greb.f90:715, :907):
    where(band & (d <= -x)) d = -0.9*x."""
    return jnp.where(jnp.logical_and(band, d <= -x), F32(-0.9) * x, d)


def _row_dot(t_row: jax.Array, f: int, k: int, const: Fast2Const,
             lowrank: bool) -> jax.Array:
    """(..., X) x composite[f, k] — plain 2-D dots."""
    lead = t_row.shape[:-1]
    flat = t_row.reshape((-1, t_row.shape[-1])) if t_row.ndim != 2 else t_row
    if lowrank:
        z = jnp.dot(flat, const.pcu[f, k], preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        out = jnp.dot(z, const.pcw[f, k], preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    else:
        out = jnp.dot(flat, const.pcomp[f, k],
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    return out.reshape(lead + (out.shape[-1],))


def _packed_comp(x, dd, const: Fast2Const, plan: FastPlan):
    """Packed block-diagonal composite application (comp_mode "packed"):
    gather the composite rows, run t2 = ((T @ U_all) * mask) @ W_all as two
    2-D f32-HIGHEST matmuls, clamp once against the composite result
    (src/greb.f90:715 semantics, as in the per-row forms)."""
    Y = plan.ydim
    ktc, kbc = plan.comp_kt, plan.comp_kb
    X = x.shape[-1]
    xs = []
    if ktc:
        xs.append(x[..., :ktc, :])
    if kbc:
        xs.append(x[..., Y - kbc:, :])
    x_slab = jnp.concatenate(xs, axis=-2) if len(xs) > 1 else xs[0]
    ds = []
    if ktc:
        ds.append(dd[..., :ktc, :])
    if kbc:
        ds.append(dd[..., Y - kbc:, :])
    d_slab = jnp.concatenate(ds, axis=-2) if len(ds) > 1 else ds[0]
    t1 = x_slab + d_slab                              # (..., F, K, X)
    lead = t1.shape[:-3]
    fk = t1.shape[-3] * t1.shape[-2]
    flat = t1.reshape(lead + (fk, X))
    rtot = const.pcu.shape[-1]
    z = jnp.dot(flat.reshape((-1, X)), const.pcu,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    z = z.reshape(lead + (fk, rtot)) * const.pmask
    t2 = jnp.dot(z.reshape((-1, rtot)), const.pcw,
                 preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    t2 = t2.reshape(lead + (fk, X)).reshape(t1.shape)
    t1 = t1 + v1._clamped(t2 - t1, t1)
    dcomp = t1 - x_slab
    segs = []
    if ktc:
        segs.append(dcomp[..., :ktc, :])
    segs.append(dd[..., ktc:Y - kbc, :])
    if kbc:
        segs.append(dcomp[..., ktc:, :])
    return jnp.concatenate(segs, axis=-2)


def _extra_diffusion(x, dd, const: Fast2Const, plan: FastPlan):
    """Extra sub-cycle iterations for rows with diffusion time2 > 1: explicit
    prefix/suffix slices (diff_segs, offset past the composite rows) plus
    the composite rows themselves.  Returns the updated full-field dd."""
    Y = plan.ydim
    ktc, kbc = plan.comp_kt, plan.comp_kb
    have_segs = bool(plan.diff_segs)
    if not (have_segs or plan.diff_composite):
        return dd

    def seg_iter(dd, r0, r1, iters):
        """Iterate rows [r0, r1) a further `iters` times, carried through dd."""
        t1 = x[..., r0:r1, :] + dd[..., r0:r1, :]
        t1 = v1._iterate(t1, const.zd[:, :, r0:r1, :], iters)
        return jnp.concatenate(
            [dd[..., :r0, :], t1 - x[..., r0:r1, :], dd[..., r1:, :]],
            axis=-2)

    # explicit segments are CUMULATIVE levels on nested prefixes of
    # [ktc, ...) / suffixes of (..., Y-kbc] (time2 monotone toward each
    # pole; see v1._segments) — apply sequentially, carrying dd
    for kt, kb, iters in plan.diff_segs:
        if kt:
            dd = seg_iter(dd, ktc, ktc + kt, iters)
        if kb:
            dd = seg_iter(dd, Y - kbc - kb, Y - kbc, iters)

    if not plan.diff_composite:
        return dd
    if plan.comp_mode == "packed":
        return _packed_comp(x, dd, const, plan)
    lowrank = plan.comp_mode == "lowrank"
    F = const.wz.shape[-3]

    def comp_rows(r0, n, k0):
        """Apply composites to rows [r0, r0+n); returns the new dd slab."""
        parts = []
        for j in range(n):
            r = r0 + j
            fparts = []
            for f in range(F):
                t1 = x[..., f, r:r + 1, :] + dd[..., f, r:r + 1, :]
                t2 = _row_dot(t1, f, k0 + j, const, lowrank)
                t1 = t1 + v1._clamped(t2 - t1, t1)
                fparts.append(t1 - x[..., f, r:r + 1, :])
            parts.append(jnp.stack(fparts, axis=-3))
        return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else parts[0]

    slabs = []
    if ktc:
        slabs.append(comp_rows(0, ktc, 0))
    slabs.append(dd[..., ktc:Y - kbc, :])
    if kbc:
        slabs.append(comp_rows(Y - kbc, kbc, ktc))
    return jnp.concatenate(slabs, axis=-2) if len(slabs) > 1 else slabs[0]


def _extra_advection(x, da, cf: Fast2Coeffs, plan: FastPlan):
    """Extra advection sub-cycle iterations (adv_segs; empty at 96x48 —
    every polar row has advective time2 == 1 there)."""
    if not plan.adv_segs:
        return da
    Y = plan.ydim
    new_da = da
    for kt, kb, iters in plan.adv_segs:
        if kt:
            t1 = x[..., :kt, :] + new_da[..., :kt, :]
            t1 = v1._iterate(t1, cf.za[:, :, :kt, :], iters)
            new_da = jnp.concatenate(
                [t1 - x[..., :kt, :], new_da[..., kt:, :]], axis=-2)
        if kb:
            t1 = x[..., Y - kb:, :] + new_da[..., Y - kb:, :]
            t1 = v1._iterate(t1, cf.za[:, :, Y - kb:, :], iters)
            new_da = jnp.concatenate(
                [new_da[..., :Y - kb, :], t1 - x[..., Y - kb:, :]], axis=-2)
    return new_da


# ---------------------------------------------------------------------------
# matmul formulation for large member batches
# ---------------------------------------------------------------------------
# Each zonal apply is x_row @ Z_row with a (X, X) banded matrix SHARED
# across members, so for a large member batch M the roll+FMA substep can
# instead run as batched (M, X) @ (X, X) matmuls.  The matrices are exact
# densifications of the 7-band coefficients (the extra X-7 zero terms
# cannot change a float32 sum), so at precision "highest" results match the
# elementwise fold up to contraction order.

@pytree_dataclass
class MxuConst:
    zd_mat: jax.Array   # (F, Y, X, X) dense zonal-diffusion row matrices
    shift1h: jax.Array  # (7, X, X) one-hot shift tensors (densify za per step)
    # matmul precision of the zonal applies: "highest" (full float32, the
    # same fidelity contract as the single-run path; the default) or "high"
    # (on an H100, TF32 tensor-core passes: ~10 mantissa bits per operand —
    # error measured in tests/test_mxu.py and PERF.md)
    precision: str = static_field(default="highest")
    # mode selects the per-substep matmul structure:
    #   "pair"    two batched matmuls (diffusion / advection) — default
    #   "stacked" ONE matmul with the two matrices stacked along the
    #             output dim (X -> 2X): halves the matmul issue count,
    #             identical math and rounding per dot
    #   "fused"   ONE matmul of the pre-folded zc = wz*zd + za for interior
    #             rows, band rows recomputed on small slabs.  Different
    #             float32 grouping (coefficients pre-multiplied by wz) —
    #             parity pinned in tests/test_mxu.py.
    mode: str = static_field(default="pair")


def build_mxu(const: Fast2Const, plan: FastPlan,
              precision: str = "highest", mode: str = "pair") -> MxuConst:
    """Densify the constant zonal-diffusion coefficients into per-row
    matrices and precompute the one-hot shift tensors used to densify the
    per-step advection coefficients on device."""
    assert precision in ("high", "highest"), precision
    assert mode in ("pair", "stacked", "fused"), mode
    zd = np.asarray(const.zd)                   # (7, F, Y, X)
    _, F, Y, X = zd.shape
    jout = np.arange(X)
    zmat = np.zeros((F, Y, X, X), np.float32)
    zmat[:, :, jout, jout] = zd[3]
    for i, s in _LON_IDX_SHIFT:
        zmat[:, :, (jout - s) % X, jout] += zd[i]
    sh = np.zeros((7, X, X), np.float32)
    sh[3, jout, jout] = 1.0
    for i, s in _LON_IDX_SHIFT:
        sh[i, (jout - s) % X, jout] = 1.0
    return MxuConst(zd_mat=jnp.asarray(zmat), shift1h=jnp.asarray(sh),
                    precision=precision, mode=mode)


def adv_matrix(za: jax.Array, mxu: MxuConst) -> jax.Array:
    """Densify one step's assembled advection coefficients (7, F, Y, X)
    into (F, Y, X, X) row matrices (one small einsum per step, amortized
    over the step's substeps).  The shift tensor is exact one-hots, so any
    matmul precision reproduces the coefficients bit-for-bit; HIGHEST keeps
    it trivially exact."""
    return jnp.einsum('sfyo,sxo->fyxo', za, mxu.shift1h,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def _row_matmul(x: jax.Array, mat: jax.Array,
                precision: str = "highest") -> jax.Array:
    """(..., F, Y, X) x (F, Y, X, X) batched over (F, Y) rows.

    ``precision`` names a ``jax.lax.Precision``: "highest" keeps full
    float32; "high" lets the backend use reduced-precision passes (TF32 on
    an H100), whose error is measured in tests/test_mxu.py."""
    prec = (jax.lax.Precision.HIGHEST if precision == "highest"
            else jax.lax.Precision.HIGH)
    return jnp.einsum('...fyx,fyxz->...fyz', x, mat,
                      preferred_element_type=jnp.float32,
                      precision=prec)


def mxu_substep(x: jax.Array, cf: Fast2Coeffs, za_mat: jax.Array,
                const: Fast2Const, mxu: MxuConst, plan: FastPlan
                ) -> jax.Array:
    """One dt_crcl substep with the zonal applies as matmuls."""
    Y = x.shape[-2]
    dd = _row_matmul(x, mxu.zd_mat, mxu.precision)
    dd = _masked_clamp(dd, x, const.band)
    dd = _extra_diffusion(x, dd, const, plan)
    if plan.seq_zonal:
        xa = x + const.wz * dd      # sequential splitting (extension grids)
    else:
        xa = x
    da = _row_matmul(xa, za_mat, mxu.precision)
    da = _masked_clamp(da, xa, const.band)
    da = _extra_advection(xa, da, cf, plan)
    xe = extend_lat_zero(x, 2)
    dy = cf.c0m * x
    dy = dy + cf.mc[0] * xe[..., 0:Y, :]
    dy = dy + cf.mc[1] * xe[..., 1:Y + 1, :]
    dy = dy + cf.mc[2] * xe[..., 3:Y + 3, :]
    dy = dy + cf.mc[3] * xe[..., 4:Y + 4, :]
    return xa + da + dy if plan.seq_zonal else x + const.wz * dd + da + dy


def _band_zonal(xs, zd_seg, za_seg):
    """Band-slab zonal diffusion + advection with the polar clamps
    (src/greb.f90:715, :907); every slab row is a band row so the clamps
    apply unmasked.  Returns (dd, da) BEFORE the outer wz."""
    dd = v1._clamped(v1._apply7(xs, zd_seg), xs)
    da = v1._clamped(v1._apply7(xs, za_seg), xs)
    return dd, da


def _band_comp(xs, dd, const: Fast2Const, plan: FastPlan, top: bool):
    """Slab-relative composite rows (the deep sub-cycled pole rows) of the
    top/bottom band slab — mirrors _extra_diffusion.comp_rows with the
    global row indices mapped into the slab."""
    assert plan.comp_mode in ("dense", "lowrank"), \
        "fused-mode band slabs do not support packed composites"
    ktc, kbc = plan.comp_kt, plan.comp_kb
    n = ktc if top else kbc
    if n == 0:
        return dd
    B = xs.shape[-2]
    lowrank = plan.comp_mode == "lowrank"
    F = const.wz.shape[-3]
    r0 = 0 if top else B - n
    k0 = 0 if top else ktc
    parts = []
    for j in range(n):
        r = r0 + j
        fparts = []
        for f in range(F):
            t1 = xs[..., f, r:r + 1, :] + dd[..., f, r:r + 1, :]
            t2 = _row_dot(t1, f, k0 + j, const, lowrank)
            t1 = t1 + v1._clamped(t2 - t1, t1)
            fparts.append(t1 - xs[..., f, r:r + 1, :])
        parts.append(jnp.stack(fparts, axis=-3))
    comp = jnp.concatenate(parts, axis=-2) if len(parts) > 1 else parts[0]
    if top:
        return jnp.concatenate([comp, dd[..., n:, :]], axis=-2)
    return jnp.concatenate([dd[..., :B - n, :], comp], axis=-2)


def _band_segs(xs, d, csegs, segs, top: bool, offset: int):
    """Slab-relative explicit extra iterations (diff_segs/adv_segs); the
    iterating rows are a slab prefix (top) / suffix (bottom) past the
    composite ``offset``."""
    B = xs.shape[-2]
    for kt, kb, iters in segs:
        k = kt if top else kb
        if not k:
            continue
        if top:
            r0, r1 = offset, offset + k
        else:
            r0, r1 = B - offset - k, B - offset
        t1 = xs[..., r0:r1, :] + d[..., r0:r1, :]
        t1 = v1._iterate(t1, csegs[:, :, r0:r1, :], iters)
        d = jnp.concatenate(
            [d[..., :r0, :], t1 - xs[..., r0:r1, :], d[..., r1:, :]],
            axis=-2)
    return d


def mxu_substep_fused(x: jax.Array, cf: Fast2Coeffs, zc_mat: jax.Array,
                      const: Fast2Const, mxu: MxuConst, plan: FastPlan
                      ) -> jax.Array:
    """One dt_crcl substep: ONE combined matmul (wz*zd + za pre-folded)
    for every row, then the band slabs (top bt / bottom bb rows, where the
    zonal increments clamp and the deep rows composite) recomputed exactly
    and overwritten.  Halves the matmul count per substep vs
    mxu_substep and drops the full-field clamps/multiplies."""
    Y = x.shape[-2]
    bt, bb = plan.bt, plan.bb
    dc = _row_matmul(x, zc_mat, mxu.precision)
    xe = extend_lat_zero(x, 2)
    dy = cf.c0m * x
    dy = dy + cf.mc[0] * xe[..., 0:Y, :]
    dy = dy + cf.mc[1] * xe[..., 1:Y + 1, :]
    dy = dy + cf.mc[2] * xe[..., 3:Y + 3, :]
    dy = dy + cf.mc[3] * xe[..., 4:Y + 4, :]
    out = x + dc + dy

    def slab(r0, r1, top):
        xs = x[..., r0:r1, :]
        dd, da = _band_zonal(xs, const.zd[:, :, r0:r1, :],
                             cf.za[:, :, r0:r1, :])
        if plan.diff_segs:
            dd = _band_segs(xs, dd, const.zd[:, :, r0:r1, :],
                            plan.diff_segs, top,
                            plan.comp_kt if top else plan.comp_kb)
        if plan.diff_composite:
            dd = _band_comp(xs, dd, const, plan, top)
        if plan.adv_segs:
            da = _band_segs(xs, da, cf.za[:, :, r0:r1, :],
                            plan.adv_segs, top, 0)
        return xs + const.wz[:, r0:r1, :] * dd + da + dy[..., r0:r1, :]

    parts = []
    if bt:
        parts.append(slab(0, bt, True))
    parts.append(out[..., bt:Y - bb, :])
    if bb:
        parts.append(slab(Y - bb, Y, False))
    return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else parts[0]


def mxu_substep_stacked(x: jax.Array, cf: Fast2Coeffs, dz_mat: jax.Array,
                        const: Fast2Const, mxu: MxuConst, plan: FastPlan
                        ) -> jax.Array:
    """One dt_crcl substep with BOTH zonal applies in one (X, 2X)-output
    matmul (out[..., :X] = diffusion, [..., X:] = advection) — identical
    per-dot math to mxu_substep, half the matmul issues."""
    Y = x.shape[-2]
    X = x.shape[-1]
    both = _row_matmul(x, dz_mat, mxu.precision)         # (..., F, Y, 2X)
    dd = both[..., :X]
    da = both[..., X:]
    dd = _masked_clamp(dd, x, const.band)
    dd = _extra_diffusion(x, dd, const, plan)
    da = _masked_clamp(da, x, const.band)
    da = _extra_advection(x, da, cf, plan)
    xe = extend_lat_zero(x, 2)
    dy = cf.c0m * x
    dy = dy + cf.mc[0] * xe[..., 0:Y, :]
    dy = dy + cf.mc[1] * xe[..., 1:Y + 1, :]
    dy = dy + cf.mc[2] * xe[..., 3:Y + 3, :]
    dy = dy + cf.mc[3] * xe[..., 4:Y + 4, :]
    return x + const.wz * dd + da + dy


def mxu_circulation(x: jax.Array, cf: Fast2Coeffs, const: Fast2Const,
                    mxu: MxuConst, plan: FastPlan, nsub: int,
                    unroll=False) -> jax.Array:
    """Sub-cycled circulation increment, matmul formulation (large
    batches)."""
    za_mat = adv_matrix(cf.za, mxu)
    if plan.seq_zonal:
        # sequential zonal splitting: advection's input depends on the
        # diffusion result, so the stacked/fused single-matmul forms do not
        # apply — use the pair form regardless of mode (extension-grid
        # ensembles are not a production config; correctness first)
        step = lambda xc: mxu_substep(xc, cf, za_mat, const, mxu, plan)
    elif mxu.mode == "fused":
        zc_mat = za_mat + mxu.zd_mat * const.wz[:, :, None, :]
        step = lambda xc: mxu_substep_fused(xc, cf, zc_mat, const, mxu,
                                            plan)
    elif mxu.mode == "stacked":
        dz_mat = jnp.concatenate([mxu.zd_mat, za_mat], axis=-1)  # (F,Y,X,2X)
        step = lambda xc: mxu_substep_stacked(xc, cf, dz_mat, const, mxu,
                                              plan)
    else:
        step = lambda xc: mxu_substep(xc, cf, za_mat, const, mxu, plan)
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


def extend_lat_zero(x: jax.Array, width: int) -> jax.Array:
    """Default meridional halo: zeros beyond the poles (one-sided forms)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(width, width), (0, 0)]
    return jnp.pad(x, pad)


# ---------------------------------------------------------------------------
# latitude-sharded variant
# ---------------------------------------------------------------------------
# Under shard_map every shard must run the SAME program.  The uniform fold
# is already shard-friendly (coefficients/masks are (Y, X) fields that shard
# like the state; lon rolls are shard-local; the meridional pass takes a
# ppermute-backed halo extension).  What needs restructuring is the extra
# sub-cycle iterations, whose row slices are GLOBAL static positions:
#
# * diffusion: ALL rows with time2 > 1 collapse into per-row composite
#   operators (no explicit segments — unlike the unsharded plan there is no
#   LOWRANK_N explicit window).  Because time2 grows monotonically toward
#   each pole, composite rows are a global top-prefix/bottom-suffix, so each
#   shard's composite rows are a LOCAL prefix/suffix — the same static
#   slice on every shard, padded with zero operators + an identity flag on
#   shards that own fewer such rows.
# * advection cannot be precomposed (its coefficients carry the step's
#   winds), so the iterating rows — also a local prefix/suffix — iterate
#   explicitly for the GLOBAL maximum count with per-level 0/1 row masks
#   (a masked row's increment is exactly 0, so the clamp keeps it 0).

from dataclasses import dataclass


@dataclass(frozen=True)
class ShardPlan:
    """Static structure of the latitude-sharded fast path."""
    ydim: int                # GLOBAL rows
    xdim: int
    n_shards: int
    kct: int                 # composite rows at each shard's local top
    kcb: int                 # ... and local bottom
    lat: int                 # adv explicit slab rows at local top
    lab: int                 # ... and local bottom
    la_levels: int           # extra advection iterations (global max - 1)
    comp_mode: str           # "dense" | "lowrank" | "none"
    # issue the ppermute halo exchange BEFORE the interior zonal work, so
    # the asynchronous collective-permute can overlap the shard-local
    # applies; the math is identical either way (the halo feeds only the
    # meridional pass), so this is purely a scheduling hint
    overlap_halo: bool = True
    # sequential zonal splitting on extension grids (see FastPlan.seq_zonal)
    seq_zonal: bool = False

    @property
    def rloc(self) -> int:
        return self.ydim // self.n_shards


@pytree_dataclass
class Fast2ShardConst:
    """Global (shardable) arrays of the sharded fast path.  Field arrays
    shard along their Y axis; the stacked composite arrays shard along the
    per-shard-block axis (n_shards * (kct+kcb))."""
    zd: jax.Array        # (7, F, Y, X)
    zam: jax.Array       # (8, F, Y, X)
    mer: jax.Array       # (9, F, Y, X)
    wz: jax.Array        # (F, Y, X)
    band: jax.Array      # (Y, 1) bool
    amask: jax.Array     # (La, Y, 1) adv per-level iteration masks (f32 0/1)
    pcomp: jax.Array     # (F, n_sh*K, X, X) dense composites (zeros if unused)
    pcu: jax.Array       # (F, n_sh*K, X, r) lowrank factors
    pcw: jax.Array       # (F, n_sh*K, r, X)
    pid: jax.Array       # (n_sh*K, 1) 1.0 where the slot is an identity pad


@dataclass(frozen=True)
class ShardGeometry:
    """Static composite/advection slab geometry of a latitude decomposition
    — derived from the grid schedules alone (cheap; no matrix powers), and
    the single source of truth shared by ``build_sharded`` and
    ``diag.memory.memory_report``."""
    kt_g: int            # global composite rows (top / bottom)
    kb_g: int
    kct: int             # per-shard local composite slab rows (top / bottom)
    kcb: int
    lat: int             # per-shard advection explicit slab rows
    lab: int
    la_levels: int
    comp_mode: str       # "dense" | "lowrank" | "none"

    @property
    def K(self) -> int:
        return self.kct + self.kcb


def sharded_geometry(grid: Grid, n_shards: int,
                     comp_dense_max_bytes: int = 512 * 2 ** 20,
                     ) -> ShardGeometry:
    Y, X = grid.ydim, grid.xdim
    assert Y % n_shards == 0, "ydim must divide evenly across shards"
    R = Y // n_shards
    d2 = np.asarray(grid.diff_sched.time2)
    a2 = np.asarray(grid.adv_sched.time2)
    # diffusion composite rows: every row with time2 > 1 (top prefix /
    # bottom suffix globally; hemispheres split at Y//2 for all-polar grids)
    half = Y // 2
    kt_g = int((d2[:half] > 1).sum())
    kb_g = int((d2[half:] > 1).sum())
    assert (d2[:kt_g] > 1).all() and (d2[kt_g:half] <= 1).all()
    assert (d2[Y - kb_g:] > 1).all() and (d2[half:Y - kb_g] <= 1).all()

    def loc_top(i):
        return int(np.clip(kt_g - i * R, 0, R))

    def loc_bot(i):
        return int(np.clip(kb_g - (n_shards - 1 - i) * R, 0, R))

    kct = max(loc_top(i) for i in range(n_shards))
    kcb = max(loc_bot(i) for i in range(n_shards))
    if kct + kcb >= R:
        # deep polar bands (768x384: composite rows exceed rows/shard):
        # the top/bottom slabs would overlap — use ONE full-width slab with
        # a slot per local row (slot index == local row, identity-padded)
        kct, kcb = R, 0
    K = kct + kcb

    F = 2
    # dense when the PER-SHARD block fits the byte budget (it lives in HBM
    # under XLA); else SVD-truncated
    if kt_g + kb_g == 0:
        mode = "none"
    elif F * K * X * X * 4 <= comp_dense_max_bytes:
        mode = "dense"
    else:
        mode = "lowrank"

    # advection explicit slabs
    la_g_t = int((a2[:half] > 1).sum())
    la_g_b = int((a2[half:] > 1).sum())
    assert (a2[:la_g_t] > 1).all() and (a2[la_g_t:half] <= 1).all()
    assert (a2[Y - la_g_b:] > 1).all()
    lat = max(int(np.clip(la_g_t - i * R, 0, R)) for i in range(n_shards))
    lab = max(int(np.clip(la_g_b - (n_shards - 1 - i) * R, 0, R))
              for i in range(n_shards))
    if lat + lab >= R:
        lat, lab = R, 0          # same full-slab collapse as the composites
    la_levels = max(int(a2.max(initial=1)) - 1, 0)
    return ShardGeometry(kt_g=kt_g, kb_g=kb_g, kct=kct, kcb=kcb,
                         lat=lat, lab=lab, la_levels=la_levels,
                         comp_mode=mode)


def build_sharded(wz_air: np.ndarray, wz_vapor: np.ndarray, grid: Grid,
                  st: stc.StencilStatic, kappa: float, n_shards: int,
                  include_advection: bool = True,
                  overlap_halo: bool = True,
                  comp_dense_max_bytes: int = 512 * 2 ** 20,
                  ) -> Tuple[ShardPlan, Fast2ShardConst]:
    """Build the sharded plan + global constant arrays for an n_shards
    latitude decomposition (ydim % n_shards == 0).

    ``comp_dense_max_bytes`` bounds the PER-SHARD dense composite block
    (F*K*X*X floats); past it the composites are SVD-truncated.  Dense is
    strongly preferred: it skips the SVD pass of the build (the dominant
    cost at 768x384 — hundreds of dgesdd calls) and is exact."""
    Y, X = grid.ydim, grid.xdim
    R = Y // n_shards
    geo = sharded_geometry(grid, n_shards, comp_dense_max_bytes)
    kt_g, kb_g = geo.kt_g, geo.kb_g
    kct, kcb, K, mode = geo.kct, geo.kcb, geo.K, geo.comp_mode
    plan, const = build_const(wz_air, wz_vapor, grid, st, kappa,
                              include_advection=include_advection,
                              with_composites=False)
    d2 = np.asarray(grid.diff_sched.time2)
    a2 = np.asarray(grid.adv_sched.time2)

    def loc_top(i):
        return int(np.clip(kt_g - i * R, 0, R))

    def loc_bot(i):
        return int(np.clip(kb_g - (n_shards - 1 - i) * R, 0, R))

    F = 2

    # placeholders keep the sharded axis divisible by n_shards even when
    # no composite rows exist (comp_mode "none")
    nk = n_shards * max(K, 1)
    pcomp = np.zeros((F, nk, X, X) if mode == "dense" else (F, nk, 1, 1), F32)
    pcu = np.zeros((F, nk, X, 1) if mode == "lowrank" else (F, nk, 1, 1), F32)
    pcw = np.zeros((F, nk, 1, X) if mode == "lowrank" else (F, nk, 1, 1), F32)
    pid = np.ones((nk, 1), F32)
    if mode != "none":
        # global composite operators for the kt_g + kb_g rows
        bidx = np.r_[np.arange(kt_g), np.arange(Y - kb_g, Y)]
        zd64 = _zonal_diffusion64(wz_air, wz_vapor, grid, st, kappa)
        pdc64 = zd64[:, :, bidx, :]
        n_extra = d2[bidx] - 1
        gplan = FastPlan(ydim=Y, xdim=X, bt=kt_g, bb=kb_g, diff_segs=(),
                         adv_segs=(), comp_mode=mode, comp_kt=kt_g,
                         comp_kb=kb_g)
        pg, pug, pwg = v1.build_composites(pdc64, n_extra, gplan, F,
                                           kt_g + kb_g, X)
        rank = pug.shape[-1]
        if mode == "lowrank":
            pcu = np.zeros((F, n_shards * K, X, rank), F32)
            pcw = np.zeros((F, n_shards * K, rank, X), F32)
        for i in range(n_shards):
            ct, cb = loc_top(i), loc_bot(i)
            for j in range(ct):                     # local top prefix
                gk = i * R + j                      # global composite index
                slot = i * K + j
                pid[slot] = 0.0
                if mode == "dense":
                    pcomp[:, slot] = pg[:, gk]
                else:
                    pcu[:, slot] = pug[:, gk]
                    pcw[:, slot] = pwg[:, gk]
            for j in range(cb):                     # local bottom suffix
                grow = (i + 1) * R - cb + j         # global row
                gk = kt_g + (grow - (Y - kb_g))     # index into bottom block
                slot = i * K + kct + (kcb - cb) + j
                pid[slot] = 0.0
                if mode == "dense":
                    pcomp[:, slot] = pg[:, gk]
                else:
                    pcu[:, slot] = pug[:, gk]
                    pcw[:, slot] = pwg[:, gk]

    # advection per-level masks (slab geometry comes from `geo`)
    lat, lab, la_levels = geo.lat, geo.lab, geo.la_levels
    amask = np.zeros((max(la_levels, 1), Y, 1), F32)
    for l in range(la_levels):
        amask[l, :, 0] = (a2 > l + 1).astype(F32)

    splan = ShardPlan(ydim=Y, xdim=X, n_shards=n_shards, kct=kct, kcb=kcb,
                      lat=lat, lab=lab, la_levels=la_levels, comp_mode=mode,
                      overlap_halo=overlap_halo,
                      seq_zonal=bool(grid.extension_mode))
    sconst = Fast2ShardConst(
        zd=const.zd, zam=const.zam, mer=const.mer, wz=const.wz,
        band=const.band, amask=jnp.asarray(amask),
        pcomp=jnp.asarray(pcomp), pcu=jnp.asarray(pcu),
        pcw=jnp.asarray(pcw), pid=jnp.asarray(pid))
    return splan, sconst


def _sharded_extra_diffusion(x, dd, const: Fast2ShardConst, splan: ShardPlan):
    """Composite rows at the local top/bottom (identity-flagged padding on
    shards that own fewer composite rows).

    All rows of a slab apply in ONE batched einsum over (F, rows), which
    keeps the graph size independent of the composite row count (96
    rows/shard at 768x384)."""
    if splan.comp_mode == "none" or (splan.kct + splan.kcb) == 0:
        return dd
    R = x.shape[-2]
    kct, kcb = splan.kct, splan.kcb
    lowrank = splan.comp_mode == "lowrank"

    def comp_block(r0, n, k0):
        xs = x[..., r0:r0 + n, :]
        t1 = xs + dd[..., r0:r0 + n, :]              # (..., F, n, X)
        if lowrank:
            z = jnp.einsum('...fkx,fkxr->...fkr', t1,
                           const.pcu[:, k0:k0 + n],
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
            t2 = jnp.einsum('...fkr,fkrz->...fkz', z,
                            const.pcw[:, k0:k0 + n],
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
        else:
            t2 = jnp.einsum('...fkx,fkxz->...fkz', t1,
                            const.pcomp[:, k0:k0 + n],
                            preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)
        # identity-flagged slots pass t1 through exactly
        t2 = t2 + const.pid[k0:k0 + n] * t1
        t1 = t1 + v1._clamped(t2 - t1, t1)
        return t1 - xs

    slabs = []
    if kct:
        slabs.append(comp_block(0, kct, 0))
    slabs.append(dd[..., kct:R - kcb, :])
    if kcb:
        slabs.append(comp_block(R - kcb, kcb, kct))
    return jnp.concatenate(slabs, axis=-2) if len(slabs) > 1 else slabs[0]


def _sharded_extra_advection(x, da, cf: Fast2Coeffs, amask, splan: ShardPlan):
    """Per-level masked iteration on the local top/bottom slabs: a masked
    row's increment is exactly zero, so non-iterating rows (and whole
    interior shards) pass through bit-exactly.  The level loop is a
    ``fori_loop`` so the graph stays small at deep schedules (85 levels at
    768x384)."""
    if splan.la_levels == 0 or (splan.lat + splan.lab) == 0:
        return da
    R = x.shape[-2]

    def slab_iter(r0, r1):
        t0 = x[..., r0:r1, :] + da[..., r0:r1, :]
        cseg = cf.za[:, :, r0:r1, :]

        def level(l, t1):
            m = jax.lax.dynamic_index_in_dim(
                amask, l, keepdims=False)[r0:r1, :]
            d = v1._apply7(t1, cseg) * m
            return t1 + v1._clamped(d, t1)

        if splan.la_levels <= 4:
            t1 = t0
            for l in range(splan.la_levels):
                t1 = level(l, t1)
        else:
            t1 = jax.lax.fori_loop(0, splan.la_levels, level, t0)
        return t1 - x[..., r0:r1, :]

    parts = []
    if splan.lat:
        parts.append(slab_iter(0, splan.lat))
    parts.append(da[..., splan.lat:R - splan.lab, :])
    if splan.lab:
        parts.append(slab_iter(R - splan.lab, R))
    return jnp.concatenate(parts, axis=-2) if len(parts) > 1 else parts[0]


def sharded_substep(x, cf: Fast2Coeffs, const: Fast2ShardConst,
                    splan: ShardPlan, extend: Callable) -> jax.Array:
    """One substep on a LOCAL latitude slab (inside shard_map); ``extend``
    supplies the width-2 meridional halo (parallel.halo).

    With ``splan.overlap_halo`` the exchange is issued FIRST: the zonal
    applies (rolls, clamps, composites, advection sub-cycles) depend only
    on local rows, so the collective-permute can proceed while they run
    (halo/compute overlap, SURVEY §2.4)."""
    R = x.shape[-2]
    xe = extend(x, 2) if splan.overlap_halo else None
    rolls = [jnp.roll(x, s, axis=-1) for _, s in _LON_IDX_SHIFT]
    dd = _apply7_rolled(rolls, x, const.zd)
    dd = _masked_clamp(dd, x, const.band)
    dd = _sharded_extra_diffusion(x, dd, const, splan)
    if splan.seq_zonal:
        # sequential zonal splitting on extension grids (FastPlan.seq_zonal)
        xa = x + const.wz * dd
        rolls_a = [jnp.roll(xa, s, axis=-1) for _, s in _LON_IDX_SHIFT]
    else:
        xa, rolls_a = x, rolls
    da = _apply7_rolled(rolls_a, xa, cf.za)
    da = _masked_clamp(da, xa, const.band)
    da = _sharded_extra_advection(xa, da, cf, const.amask, splan)
    if xe is None:
        xe = extend(x, 2)
    dy = cf.c0m * x
    dy = dy + cf.mc[0] * xe[..., 0:R, :]
    dy = dy + cf.mc[1] * xe[..., 1:R + 1, :]
    dy = dy + cf.mc[2] * xe[..., 3:R + 3, :]
    dy = dy + cf.mc[3] * xe[..., 4:R + 4, :]
    if splan.seq_zonal:
        return xa + da + dy
    return x + const.wz * dd + da + dy


def sharded_circulation(x, cf: Fast2Coeffs, const: Fast2ShardConst,
                        splan: ShardPlan, nsub: int, extend: Callable,
                        unroll=False) -> jax.Array:
    """Sub-cycled circulation increment on a local slab (shard_map body)."""
    step = lambda xc: sharded_substep(xc, cf, const, splan, extend)
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


def substep(x: jax.Array, cf: Fast2Coeffs, const: Fast2Const, plan: FastPlan,
            extend: Callable = extend_lat_zero) -> jax.Array:
    """One dt_crcl circulation substep on the (..., F, Y, X) stacked field.

    With ``plan.seq_zonal`` (extension grids) the zonal advection reads the
    zonally-DIFFUSED state (sequential splitting; see FastPlan.seq_zonal);
    reference-envelope grids keep the reference's additive increments."""
    Y = x.shape[-2]
    rolls = [jnp.roll(x, s, axis=-1) for _, s in _LON_IDX_SHIFT]
    band = const.band

    # zonal diffusion (clamped on band rows), then extra iterations
    dd = _apply7_rolled(rolls, x, const.zd)
    dd = _masked_clamp(dd, x, band)
    dd = _extra_diffusion(x, dd, const, plan)

    # zonal advection (clamped on band rows)
    if plan.seq_zonal:
        xa = x + const.wz * dd
        rolls_a = [jnp.roll(xa, s, axis=-1) for _, s in _LON_IDX_SHIFT]
    else:
        xa, rolls_a = x, rolls
    da = _apply7_rolled(rolls_a, xa, cf.za)
    da = _masked_clamp(da, xa, band)
    da = _extra_advection(xa, da, cf, plan)

    # meridional diffusion+advection, merged (never clamped; reads the
    # substep's initial state — the additive meridional term M of the
    # stability model)
    xe = extend(x, 2)
    dy = cf.c0m * x
    dy = dy + cf.mc[0] * xe[..., 0:Y, :]        # km2
    dy = dy + cf.mc[1] * xe[..., 1:Y + 1, :]    # km1
    dy = dy + cf.mc[2] * xe[..., 3:Y + 3, :]    # kp1
    dy = dy + cf.mc[3] * xe[..., 4:Y + 4, :]    # kp2

    if plan.seq_zonal:
        return xa + da + dy
    return x + const.wz * dd + da + dy


def circulation(x: jax.Array, cf: Fast2Coeffs, const: Fast2Const,
                plan: FastPlan, nsub: int, unroll=False,
                extend: Callable = extend_lat_zero) -> jax.Array:
    """Sub-cycled circulation increment over one 12-h step (uniform fold).
    Same contract as stencils.circulation: returns the total increment."""
    step = lambda xc: substep(xc, cf, const, plan, extend)
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
