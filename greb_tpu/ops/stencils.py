"""Finite-difference stencil operators: diffusion, advection, circulation.

Reference: subroutines ``diffusion`` (src/greb.f90:556-723), ``advection``
(:726-915) and ``circulation`` (:528-553).

Design decisions (vs. the reference's per-row Fortran loops):

* Fields are (..., R, X) [lat, lon] arrays; all lon stencils are expressed as
  ``jnp.roll`` (periodic) and all lat stencils as static slices of a
  halo-extended array, so the whole operator is a handful of fused
  elementwise ops — no scalar loops, no dynamic shapes.
* The reference's per-latitude polar CFL sub-cycling
  (:651-718, :838-911) has data-independent iteration counts (they depend
  only on grid geometry + kappa + dt_crcl), so the counts are computed at
  trace time (see grid.PolarSchedule) and the sub-cycle becomes a statically
  unrolled loop over ALL rows with per-row 0/1 iteration masks.  Rows done
  iterating (or non-polar rows) receive a zero increment; the result is
  selected per-row between the vectorized branch and the sub-cycled branch.
  This keeps the program SPMD-uniform: under ``shard_map`` every shard runs
  the same trace, with the per-row constants passed as *sharded arrays*
  (StencilFields) rather than baked-in constants.
* Meridional boundary forms (one-sided at the poles) are encoded by
  zero-filled halos (which nullify out-of-domain terms exactly like the
  reference's dropped terms) plus two static row masks for the asymmetric
  "/3" placement in the advection forms (:764-795).
* The reference's index quirk at src/greb.f90:881 (polar advection,
  j=xdim-2 uses jp2=xdim-1 instead of xdim) is reproduced behind
  ``quirk_jp2`` for bit-comparable behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass
from ..grid import Grid

F32 = np.float32
Extend = Callable[[jax.Array, int], jax.Array]


def extend_lat_zero(x: jax.Array, width: int) -> jax.Array:
    """Zero-fill lat halos: (..., R, X) -> (..., R+2*width, X).
    Zero halos reproduce the reference's one-sided pole forms exactly
    (dropped neighbour terms carry a wz factor of 0)."""
    pad = [(0, 0)] * (x.ndim - 2) + [(width, width), (0, 0)]
    return jnp.pad(x, pad)


# ---------------------------------------------------------------------------
# Per-row constants as arrays (shardable along R)
# ---------------------------------------------------------------------------
@pytree_dataclass
class StencilFields:
    dxlat2: jax.Array       # (R,1) dxlat**2 [m^2]
    diff_dtdff2: jax.Array  # (R,1) polar diffusion sub-step [s] (0 if unused)
    diff_itm: jax.Array     # (Id,R,1) 0/1 diffusion sub-cycle iteration masks
    adv_ccx2: jax.Array     # (R,1) polar advection coefficient
    adv_itm: jax.Array      # (Ia,R,1) 0/1 advection iteration masks
    ccx_adv: jax.Array      # (R,1) dt_crcl/dxlat/2
    polar: jax.Array        # (R,1) bool — row uses the sub-cycled branch
    row_mfull: jax.Array    # (R,1) bool — advection dTy: v_m part NOT /3 (global row 1)
    row_pfull: jax.Array    # (R,1) bool — advection dTy: v_p part NOT /3 (global row ydim-2)


@dataclass(frozen=True)
class StencilStatic:
    xdim: int
    dyy: float              # f32 meridional grid length [m]
    dt_crcl: float
    diff_max_iter: int
    adv_max_iter: int
    quirk_jp2: bool = True
    # Polar rows form two contiguous bands; when compact_polar is set, the
    # sub-cycled branch runs only on those bands (a ~2x stencil-work cut).
    # Must be False under latitude sharding (band indices are GLOBAL rows;
    # the masked full-field form is the SPMD-uniform one).
    polar_top: int = 0      # rows [0, polar_top)
    polar_bot: int = 0      # rows [R - polar_bot, R)
    compact_polar: bool = True
    # Extension grids: apply zonal advection to the zonally-diffused state
    # (sequential splitting — see ops/fastcirc.FastPlan.seq_zonal for the
    # stability rationale); reference-envelope grids keep the additive
    # reference form (src/greb.f90:546-550) exactly.
    seq_zonal: bool = False


def make_stencil_arrays(grid: Grid, quirk_jp2: bool = True):
    """Build (StencilStatic, StencilFields-as-numpy) from grid metrics."""
    R = grid.ydim
    col = lambda a: np.asarray(a, F32).reshape(R, 1)
    dsched, asched = grid.diff_sched, grid.adv_sched

    def iter_masks(time2: np.ndarray, max_iter: int) -> np.ndarray:
        if max_iter == 0:
            return np.zeros((1, R, 1), F32)
        return np.stack([(time2 > i).astype(F32).reshape(R, 1)
                         for i in range(max_iter)])

    fields = StencilFields(
        dxlat2=col(grid.dxlat.astype(F32) ** 2),
        diff_dtdff2=col(dsched.dtdff2),
        diff_itm=iter_masks(dsched.time2, dsched.max_iter),
        adv_ccx2=col(asched.ccx2),
        adv_itm=iter_masks(asched.time2, asched.max_iter),
        ccx_adv=col(grid.ccx_adv),
        polar=col(grid.polar_rows).astype(bool),
        row_mfull=col(np.arange(R) == 1).astype(bool),
        row_pfull=col(np.arange(R) == R - 2).astype(bool),
    )
    polar = np.asarray(grid.polar_rows, bool)
    kt = int(np.argmin(polar)) if not polar.all() else R
    kb = int(np.argmin(polar[::-1])) if not polar.all() else 0
    contiguous = bool(
        polar.all() or
        (polar[:kt].all() and polar[R - kb:].all()
         and not polar[kt:R - kb].any()))
    static = StencilStatic(
        xdim=grid.xdim, dyy=float(F32(grid.dyy)), dt_crcl=float(grid.dt_crcl),
        diff_max_iter=dsched.max_iter, adv_max_iter=asched.max_iter,
        quirk_jp2=quirk_jp2,
        polar_top=kt if contiguous else 0,
        polar_bot=kb if contiguous else 0,
        compact_polar=contiguous,
        seq_zonal=bool(grid.extension_mode),
    )
    return static, fields


# ---------------------------------------------------------------------------
# lon shifts
# ---------------------------------------------------------------------------
class LonShifts(NamedTuple):
    """x rolled by -3..+3 along lon. m1 = value at j-1 (roll +1), etc."""
    c: jax.Array
    m1: jax.Array
    m2: jax.Array
    m3: jax.Array
    p1: jax.Array
    p2: jax.Array
    p3: jax.Array
    p2q: jax.Array  # p2 with the src/greb.f90:881 quirk applied


def _quirk_mask(xdim: int) -> jax.Array:
    # iota-based, not a captured constant
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, xdim), 1)
    return cols == (xdim - 3)  # Fortran j = xdim-2


def lon_shifts(x: jax.Array, xdim: int, quirk: bool) -> LonShifts:
    r = lambda s: jnp.roll(x, s, axis=-1)
    p1, p2 = r(-1), r(-2)
    if quirk:
        p2q = jnp.where(_quirk_mask(xdim), p1, p2)
    else:
        p2q = p2
    return LonShifts(c=x, m1=r(1), m2=r(2), m3=r(3), p1=p1, p2=p2, p3=r(-3), p2q=p2q)


class WzPack(NamedTuple):
    """Topography weights: lon shifts + lat-extended slices (width 2)."""
    lon: LonShifts
    km1: jax.Array
    km2: jax.Array
    kp1: jax.Array
    kp2: jax.Array


def make_wz_pack(wz: jax.Array, st: StencilStatic, extend: Extend) -> WzPack:
    wze = extend(wz, 2)
    return WzPack(
        lon=lon_shifts(wz, st.xdim, st.quirk_jp2),
        km1=wze[..., 1:-3, :], km2=wze[..., :-4, :],
        kp1=wze[..., 3:-1, :], kp2=wze[..., 4:, :],
    )


# ---------------------------------------------------------------------------
# zonal stencil kernels (shared by main + polar branches)
# ---------------------------------------------------------------------------
def _diff7(t: LonShifts, w: LonShifts, cc) -> jax.Array:
    """Smoothed 3rd-order 7-point diffusion stencil
    (src/greb.f90:617-626, weights 10/4/1 over neighbour differences)."""
    return cc * (
        10.0 * (w.m1 * (t.m1 - t.c) + w.p1 * (t.p1 - t.c))
        + 4.0 * (w.m2 * (t.m2 - t.m1) + w.m1 * (t.c - t.m1))
        + 4.0 * (w.p1 * (t.c - t.p1) + w.p2 * (t.p2 - t.p1))
        + 1.0 * (w.m3 * (t.m3 - t.m2) + w.m2 * (t.m1 - t.m2))
        + 1.0 * (w.p2 * (t.p1 - t.p2) + w.p3 * (t.p3 - t.p2))) / 20.0


def _adv_upwind2(t: LonShifts, w: LonShifts, u_m, u_p, cc) -> jax.Array:
    """2-point upwind zonal advection (src/greb.f90:814-820)."""
    return cc * (
        -u_m * (w.m1 * (t.c - t.m1) + w.m2 * (t.c - t.m2))
        + u_p * (w.p1 * (t.c - t.p1) + w.p2 * (t.c - t.p2))) / 3.0


def _adv_smooth3(t: LonShifts, w: LonShifts, u_m, u_p, cc, quirk: bool) -> jax.Array:
    """Smoothed 10/4/1 3-point upwind used in the polar sub-cycle
    (src/greb.f90:842-906), incl. the jp2 quirk at j=xdim-2 (:881)."""
    tp2 = t.p2q if quirk else t.p2
    wp2 = w.p2q if quirk else w.p2
    return cc * (
        -u_m * (10.0 * w.m1 * (t.c - t.m1)
                + 4.0 * w.m2 * (t.m1 - t.m2)
                + 1.0 * w.m3 * (t.m2 - t.m3))
        + u_p * (10.0 * w.p1 * (t.c - t.p1)
                 + 4.0 * wp2 * (t.p1 - tp2)
                 + 1.0 * w.p3 * (tp2 - t.p3))) / 20.0


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------
# Polar sub-cycles unroll for small iteration counts (96x48: <=8); refined
# grids reach counts in the hundreds-to-thousands (384x192 pole row: 1800,
# reference formula src/greb.f90:651-654), where unrolling would explode the
# trace — switch to a fori_loop with the same masked-update semantics.
_UNROLL_LIMIT = 16


def _subcycle(x0: jax.Array, itm: jax.Array, max_iter: int,
              step_fn) -> jax.Array:
    """Masked clamped iteration: t1h += clamp(step_fn(t1h)) * itm[i]."""
    def one(t1h, m):
        d = step_fn(t1h)
        d = jnp.where(d <= -t1h, -0.9 * t1h, d)  # clamp (:715, :907)
        return t1h + d * m

    if max_iter <= _UNROLL_LIMIT:
        t1h = x0
        for i in range(max_iter):
            t1h = one(t1h, itm[i])
        return t1h

    def body(i, t1h):
        m = jax.lax.dynamic_index_in_dim(itm, i, 0, keepdims=False)
        return one(t1h, m)

    return jax.lax.fori_loop(0, max_iter, body, x0)


def _band_slices(st: StencilStatic, R: int):
    """Row slices of the two contiguous polar bands."""
    out = []
    if st.polar_top > 0:
        out.append(slice(0, st.polar_top))
    if st.polar_bot > 0:
        out.append(slice(R - st.polar_bot, R))
    return out


def _rows(tree, sl: slice):
    """Slice the lat axis (-2) of every array in a NamedTuple/array."""
    f = lambda a: a[..., sl, :]
    if isinstance(a := tree, jax.Array):
        return f(a)
    return type(tree)(*[f(v) for v in tree])


def _assemble_rows(mid: jax.Array, parts, st: StencilStatic) -> jax.Array:
    """Concatenate [top band, mid band, bottom band] along lat.  ``parts``
    holds the band results in _band_slices order (top first)."""
    segs = []
    it = iter(parts)
    if st.polar_top > 0:
        segs.append(next(it))
    segs.append(mid)
    if st.polar_bot > 0:
        segs.append(next(it))
    return jnp.concatenate(segs, axis=-2) if len(segs) > 1 else mid


def diffusion(x: jax.Array, wz: jax.Array, pack: WzPack, st: StencilStatic,
              sf: StencilFields, kappa, extend: Extend = extend_lat_zero,
              split: bool = False):
    """dX_diffuse = wz * (dTx + dTy); reference src/greb.f90:556-723.
    ``split=True`` returns the raw (dtx, dty) pair instead (the sequential
    extension-mode substep applies wz to each part separately)."""
    xe = extend(x, 2)
    x_km1, x_kp1 = xe[..., 1:-3, :], xe[..., 3:-1, :]
    dtc = jnp.float32(st.dt_crcl)
    ccy = kappa * dtc / jnp.float32(st.dyy) ** 2
    dty = ccy * (pack.km1 * (x_km1 - x) + pack.kp1 * (x_kp1 - x))

    if st.diff_max_iter > 0 and st.compact_polar:
        # zonal stencils are row-local: compute the vectorized 7-point form
        # only on the non-polar mid band, and the sub-cycled form only on
        # the two polar bands (their vectorized result would be discarded)
        R = x.shape[-2]
        mid = slice(st.polar_top, R - st.polar_bot)
        xm = x[..., mid, :]
        tsm = lon_shifts(xm, st.xdim, quirk=False)
        ccx_m = (kappa * dtc) / sf.dxlat2[mid]
        dtx = _diff7(tsm, _rows(pack.lon, mid), ccx_m)
        parts = []
        for sl in _band_slices(st, R):
            xb = x[..., sl, :]
            wb = _rows(pack.lon, sl)
            ccx2 = (kappa * sf.diff_dtdff2[sl]) / sf.dxlat2[sl]
            itm = sf.diff_itm[:, sl]
            t1h = _subcycle(
                xb, itm, st.diff_max_iter,
                lambda t: _diff7(lon_shifts(t, st.xdim, quirk=False), wb, ccx2))
            parts.append(t1h - xb)
        dtx = _assemble_rows(dtx, parts, st)
    else:
        ts = lon_shifts(x, st.xdim, quirk=False)
        ccx = (kappa * dtc) / sf.dxlat2
        dtx = _diff7(ts, pack.lon, ccx)
        if st.diff_max_iter > 0:  # masked full-field form (sharded path)
            ccx2 = (kappa * sf.diff_dtdff2) / sf.dxlat2
            t1h = _subcycle(
                x, sf.diff_itm, st.diff_max_iter,
                lambda t: _diff7(lon_shifts(t, st.xdim, quirk=False),
                                 pack.lon, ccx2))
            dtx = jnp.where(sf.polar, t1h - x, dtx)

    if split:
        return dtx, dty
    return wz * (dtx + dty)


def advection(x: jax.Array, pack: WzPack, u_m, u_p, v_m, v_p,
              st: StencilStatic, sf: StencilFields,
              extend: Extend = extend_lat_zero,
              x_zonal: jax.Array = None) -> jax.Array:
    """dX_advec = dTx + dTy; reference src/greb.f90:726-915.

    ``x_zonal`` (sequential extension-mode substep) supplies a different
    state for the ZONAL part (the zonally-diffused field); the meridional
    part always reads ``x`` — mirroring the folded path, whose merged
    meridional coefficients read the substep's initial state."""
    xz = x if x_zonal is None else x_zonal
    xe = extend(x, 2)
    x_km1, x_km2 = xe[..., 1:-3, :], xe[..., :-4, :]
    x_kp1, x_kp2 = xe[..., 3:-1, :], xe[..., 4:, :]

    # meridional upwind; zero halos nullify out-of-domain terms, masks place
    # the asymmetric /3 of the boundary forms (:756-795)
    t_km1 = pack.km1 * (x - x_km1)
    t_km2 = pack.km2 * (x - x_km2)
    t_kp1 = pack.kp1 * (x - x_kp1)
    t_kp2 = pack.kp2 * (x - x_kp2)
    s_m = v_m * (t_km1 + t_km2)
    s_p = v_p * (t_kp1 + t_kp2)
    ccy = jnp.float32(st.dt_crcl / st.dyy / 2.0)
    dty = ccy * (-jnp.where(sf.row_mfull, s_m, s_m / 3.0)
                 + jnp.where(sf.row_pfull, s_p, s_p / 3.0))

    if st.adv_max_iter > 0 and st.compact_polar:
        R = x.shape[-2]
        mid = slice(st.polar_top, R - st.polar_bot)
        xm = xz[..., mid, :]
        tsm = lon_shifts(xm, st.xdim, quirk=False)
        dtx = _adv_upwind2(tsm, _rows(pack.lon, mid),
                           u_m[..., mid, :], u_p[..., mid, :],
                           sf.ccx_adv[mid])
        parts = []
        for sl in _band_slices(st, R):
            xb = xz[..., sl, :]
            wb = _rows(pack.lon, sl)
            ub_m, ub_p = u_m[..., sl, :], u_p[..., sl, :]
            cc2 = sf.adv_ccx2[sl]
            itm = sf.adv_itm[:, sl]
            t1h = _subcycle(
                xb, itm, st.adv_max_iter,
                lambda t: _adv_smooth3(
                    lon_shifts(t, st.xdim, quirk=st.quirk_jp2), wb,
                    ub_m, ub_p, cc2, st.quirk_jp2))
            parts.append(t1h - xb)
        dtx = _assemble_rows(dtx, parts, st)
    else:
        ts = lon_shifts(xz, st.xdim, quirk=False)
        dtx = _adv_upwind2(ts, pack.lon, u_m, u_p, sf.ccx_adv)

    if st.adv_max_iter > 0 and not st.compact_polar:
        t1h = _subcycle(
            xz, sf.adv_itm, st.adv_max_iter,
            lambda t: _adv_smooth3(
                lon_shifts(t, st.xdim, quirk=st.quirk_jp2), pack.lon,
                u_m, u_p, sf.adv_ccx2, st.quirk_jp2))
        dtx = jnp.where(sf.polar, t1h - xz, dtx)

    return dtx + dty


def circulation(x: jax.Array, wz: jax.Array, u_m, u_p, v_m, v_p,
                st: StencilStatic, sf: StencilFields, kappa, nsub: int,
                extend: Extend = extend_lat_zero,
                include_advection: bool = True,
                unroll: bool = False) -> jax.Array:
    """Sub-cycled diffusion+advection increment over one model step.
    Reference: circulation, src/greb.f90:528-553 (nsub = dt/dt_crcl = 24).
    ``include_advection=False`` reproduces legacy log_exp==8 (vapor
    diffusion-only, greb.original.model.f90:560-565)."""
    pack = make_wz_pack(wz, st, extend)

    def substep(xc):
        if st.seq_zonal:
            # extension grids: zonal advection reads the zonally-diffused
            # state (sequential splitting; StencilStatic.seq_zonal); the
            # meridional terms stay additive from xc
            dtx, dty = diffusion(xc, wz, pack, st, sf, kappa, extend,
                                 split=True)
            xz = xc + wz * dtx
            if include_advection:
                dxa = advection(xc, pack, u_m, u_p, v_m, v_p, st, sf, extend,
                                x_zonal=xz)
                return xz + wz * dty + dxa
            return xz + wz * dty
        dxd = diffusion(xc, wz, pack, st, sf, kappa, extend)
        if include_advection:
            dxa = advection(xc, pack, u_m, u_p, v_m, v_p, st, sf, extend)
            return xc + dxd + dxa
        return xc + dxd

    # unroll: True = fully unrolled; int U > 1 = fori_loop over nsub//U with
    # U substeps per iteration (compile-time / runtime tradeoff); otherwise a
    # fori_loop.
    if unroll is True:
        xc = x
        for _ in range(nsub):
            xc = substep(xc)
    elif isinstance(unroll, int) and 1 < unroll <= nsub and nsub % unroll == 0:
        def block(i, xc):
            for _ in range(unroll):
                xc = substep(xc)
            return xc
        xc = jax.lax.fori_loop(0, nsub // unroll, block, x)
    else:
        xc = jax.lax.fori_loop(0, nsub, lambda i, xc: substep(xc), x)
    return xc - x
