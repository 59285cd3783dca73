"""Literal NumPy oracle of the reference GREB model.

This is a test-only reimplementation that follows the Fortran reference
(src/greb.f90) line-by-line — same float32 arithmetic order, same boundary
forms, same integer sub-cycling semantics, same index quirk at
src/greb.f90:881 — used as the golden regression target for the accelerator-native
implementation (the reference Fortran itself cannot be compiled in this
environment; no gfortran).

Arrays are (ydim, xdim) [lat, lon] float32; k indexes latitude rows
(0-based; Fortran k-1), j indexes longitude (0-based; Fortran j-1).
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def nint(x):
    """Fortran NINT (round half away from zero)."""
    return int(np.floor(x + 0.5)) if x >= 0 else int(np.ceil(x - 0.5))


class OracleParams:
    """mo_physics defaults (src/greb.f90:68-101)."""

    def __init__(self, **over):
        self.pi = F32(3.1416)
        self.sig = F32(5.6704e-8)
        self.rho_ocean = F32(999.1)
        self.rho_land = F32(2600.0)
        self.rho_air = F32(1.2)
        self.cp_ocean = F32(4186.0)
        self.cp_land = F32(926.222)
        self.cp_air = F32(1005.0)
        self.eps = F32(1.0)
        self.d_ocean = F32(50.0)
        self.d_land = F32(2.0)
        self.d_air = F32(5000.0)
        self.ct_sens = F32(22.5)
        self.da_ice = F32(0.25)
        self.a_no_ice = F32(0.1)
        self.a_cloud = F32(0.35)
        self.Tl_ice1 = F32(273.15 - 10.0)
        self.Tl_ice2 = F32(273.15)
        self.To_ice1 = F32(273.15 - 7.0)
        self.To_ice2 = F32(273.15 - 1.7)
        self.co_turb = F32(5.0)
        self.kappa = F32(8e5)
        self.ce = F32(2e-3)
        self.cq_latent = F32(2.257e6)
        self.cq_rain = F32(-0.1) / F32(24.0) / F32(3600.0)
        self.z_air = F32(8400.0)
        self.z_vapor = F32(5000.0)
        self.r_qviwv = F32(2.6736e3)
        self.p_emi = np.array([9.0721, 106.7252, 61.5562, 0.0179, 0.0028,
                               0.0570, 0.3462, 2.3406, 0.7032, 1.0662], F32)
        for k, v in over.items():
            setattr(self, k, F32(v) if np.isscalar(v) else np.asarray(v, F32))


class GrebOracle:
    def __init__(self, forcing: dict, params: OracleParams = None,
                 xdim=96, ydim=48, dt=43200, dt_crcl=1800, nstep_yr=730,
                 ndays_yr=365, log_exp=None):
        p = params or OracleParams()
        self.p = p
        self.xdim, self.ydim = xdim, ydim
        self.dt, self.dt_crcl = dt, dt_crcl
        self.nstep_yr, self.ndays_yr = nstep_yr, ndays_yr
        self.ndt_days = 24 * 3600 // dt
        self.dlon = F32(360.0) / F32(xdim)
        self.dlat = F32(180.0) / F32(ydim)
        self.log_exp = log_exp

        f32a = lambda a: np.asarray(a, F32).copy()
        self.z_topo = f32a(forcing["z_topo"])
        self.glacier = f32a(forcing["glacier"])
        self.tclim = f32a(forcing["tclim"])
        self.uclim = f32a(forcing["uclim"])
        self.vclim = f32a(forcing["vclim"])
        self.qclim = f32a(forcing["qclim"])
        self.mldclim = f32a(forcing["mldclim"])
        self.swetclim = f32a(forcing["swetclim"])
        self.cldclim = f32a(forcing["cldclim"])
        self.sw_solar = f32a(forcing["sw_solar"])

        e = log_exp
        if e is not None:
            # legacy switchboard field overrides (greb.original.model.f90:162-166)
            if e == 1:
                self.z_topo = np.where(self.z_topo > 1.0, F32(1.0), self.z_topo)
            if e <= 2:
                self.cldclim[:] = F32(0.7)
            if e <= 3:
                self.qclim[:] = F32(0.0052)
            if e <= 9 or e == 11:
                self.mldclim[:] = p.d_ocean

        # Toclim (src/greb.f90:1088-1094)
        toc = self.tclim.min(axis=0)
        toc = np.where(toc - F32(273.15) < F32(-1.7), F32(-1.7 + 273.15), toc)
        self.toclim = toc.astype(F32)

        # greb_model derivations (src/greb.f90:176-216)
        self.dtrad = (F32(-0.16) * self.tclim - F32(5.0)).astype(F32)
        self.z_ocean = F32(3.0) * self.mldclim.max(axis=0)
        self.cap_ocean = p.cp_ocean * p.rho_ocean
        self.cap_land = p.cp_land * p.rho_land * p.d_land
        self.cap_air = p.cp_air * p.rho_air * p.d_air
        self.cap_surf = np.where(self.z_topo > 0.0, self.cap_land,
                                 self.cap_ocean * self.mldclim[0]).astype(F32)
        self.wz_air = np.exp(-self.z_topo / p.z_air, dtype=F32)
        self.wz_vapor = np.exp(-self.z_topo / p.z_vapor, dtype=F32)
        self.uclim_m = np.where(self.uclim >= 0.0, self.uclim, F32(0.0))
        self.uclim_p = np.where(self.uclim >= 0.0, F32(0.0), self.uclim)
        self.vclim_m = np.where(self.vclim >= 0.0, self.vclim, F32(0.0))
        self.vclim_p = np.where(self.vclim >= 0.0, F32(0.0), self.vclim)

        # grid metrics shared by diffusion/advection (:578-582, :749-753)
        deg = F32(2.0) * p.pi * F32(6.371e6) / F32(360.0)
        self.dyy = self.dlat * deg
        ilat = np.arange(1, ydim + 1, dtype=F32)
        lat = self.dlat * ilat - self.dlat / F32(2.0) - F32(90.0)
        self.dxlat = (self.dlon * deg
                      * np.cos(F32(2.0) * p.pi / F32(360.0) * lat, dtype=F32))

    # -- initial state (src/greb.f90:194-197) -------------------------------
    def initial_state(self):
        ts = self.tclim[-1].copy()
        return dict(ts=ts, ta=ts.copy(), to=self.toclim.copy(),
                    q=self.qclim[-1].copy())

    # -- physics ops ---------------------------------------------------------
    def sw_radiation(self, ts, ityr):
        """src/greb.f90:367-403"""
        p = self.p
        a_atmos = self.cldclim[ityr] * p.a_cloud
        a_surf = np.empty_like(ts)
        zt, g = self.z_topo, self.glacier
        land = zt >= 0.0
        ocean = zt < 0.0
        a_surf[land & (ts <= p.Tl_ice1)] = p.a_no_ice + p.da_ice
        a_surf[land & (ts >= p.Tl_ice2)] = p.a_no_ice
        m = land & (ts > p.Tl_ice1) & (ts < p.Tl_ice2)
        a_surf[m] = (p.a_no_ice + p.da_ice
                     * (F32(1.0) - (ts[m] - p.Tl_ice1) / (p.Tl_ice2 - p.Tl_ice1)))
        a_surf[ocean & (ts <= p.To_ice1)] = p.a_no_ice + p.da_ice
        a_surf[ocean & (ts >= p.To_ice2)] = p.a_no_ice
        m = ocean & (ts > p.To_ice1) & (ts < p.To_ice2)
        a_surf[m] = (p.a_no_ice + p.da_ice
                     * (F32(1.0) - (ts[m] - p.To_ice1) / (p.To_ice2 - p.To_ice1)))
        a_surf[g > 0.5] = p.a_no_ice + p.da_ice
        if self.log_exp is not None and self.log_exp <= 5:
            a_surf[:] = p.a_no_ice
        albedo = a_surf + a_atmos - a_surf * a_atmos
        sw = self.sw_solar[ityr][:, None] * (F32(1.0) - albedo)
        return sw.astype(F32), albedo.astype(F32)

    def lw_radiation(self, ts, ta, q, co2, ityr):
        """src/greb.f90:407-434"""
        p = self.p
        pe = p.p_emi
        e_co2 = np.exp(-self.z_topo / p.z_air, dtype=F32) * F32(co2)
        e_vapor = np.exp(-self.z_topo / p.z_air, dtype=F32) * p.r_qviwv * q
        if self.log_exp == 11:
            e_vapor = (np.exp(-self.z_topo / p.z_air, dtype=F32)
                       * p.r_qviwv * self.qclim[ityr])
        e_cloud = self.cldclim[ityr]
        em = (pe[3] * np.log(pe[0] * e_co2 + pe[1] * e_vapor + pe[2], dtype=F32)
              + pe[6]
              + pe[4] * np.log(pe[0] * e_co2 + pe[2], dtype=F32)
              + pe[5] * np.log(pe[1] * e_vapor + pe[2], dtype=F32))
        em = (pe[7] - e_cloud) / pe[8] * (em - pe[9]) + pe[9]
        if self.log_exp == 11:
            em = em + F32(0.022) / (F32(0.15) * F32(24.0)) * p.r_qviwv * (q - self.qclim[ityr])
        lw_surf = -p.sig * ts ** 4
        lwair_down = -em * p.sig * (ta + self.dtrad[ityr]) ** 4
        return (lw_surf.astype(F32), lwair_down.astype(F32),
                lwair_down.astype(F32), em.astype(F32))

    def hydro(self, ts, q, ityr):
        """src/greb.f90:438-469"""
        p = self.p
        zero = np.zeros_like(ts)
        if self.log_exp is not None and (self.log_exp <= 6
                                         or self.log_exp in (13, 15)):
            return zero, zero, zero, zero
        abswind = np.sqrt(self.uclim[ityr] ** 2 + self.vclim[ityr] ** 2,
                          dtype=F32)
        m = self.z_topo > 0.0
        abswind[m] = np.sqrt(abswind[m] ** 2 + F32(2.0) ** 2, dtype=F32)
        m = self.z_topo < 0.0
        abswind[m] = np.sqrt(abswind[m] ** 2 + F32(3.0) ** 2, dtype=F32)
        qs = F32(3.75e-3) * np.exp(
            F32(17.08085) * (ts - F32(273.15)) / (ts - F32(273.15) + F32(234.175)),
            dtype=F32)
        qs = qs * np.exp(-self.z_topo / p.z_air, dtype=F32)
        q_lat = (q - qs) * abswind * p.cq_latent * p.rho_air * p.ce * self.swetclim[ityr]
        dq_eva = -q_lat / p.cq_latent / p.r_qviwv
        dq_rain = p.cq_rain * q
        q_lat_air = -dq_rain * p.cq_latent * p.r_qviwv
        return (q_lat.astype(F32), q_lat_air.astype(F32),
                dq_eva.astype(F32), dq_rain.astype(F32))

    def seaice(self, ts, ityr):
        """src/greb.f90:472-492; mutates self.cap_surf like the module var."""
        p = self.p
        cap = self.cap_surf
        zt = self.z_topo
        mld = self.mldclim[ityr]
        if self.log_exp is not None and self.log_exp <= 5:
            cap[zt > 0.0] = self.cap_land
            m = zt < 0.0
            cap[m] = self.cap_ocean * mld[m]
        else:
            m = (zt < 0.0) & (ts <= p.To_ice1)
            cap[m] = self.cap_land
            m = (zt < 0.0) & (ts >= p.To_ice2)
            cap[m] = self.cap_ocean * mld[m]
            m = (zt < 0.0) & (ts > p.To_ice1) & (ts < p.To_ice2)
            cap[m] = (self.cap_land
                      + (self.cap_ocean * mld[m] - self.cap_land)
                      / (p.To_ice2 - p.To_ice1) * (ts[m] - p.To_ice1))
        cap[self.glacier > 0.5] = self.cap_land

    def deep_ocean(self, ts, to, ityr):
        """src/greb.f90:495-525"""
        p = self.p
        dT_ocean = np.zeros_like(ts)
        dTo = np.zeros_like(ts)
        e = self.log_exp
        if e is not None and (e <= 9 or e == 11 or 14 <= e <= 16):
            return dT_ocean, dTo
        mld = self.mldclim[ityr]
        mld_prev = self.mldclim[ityr - 1] if ityr > 0 else self.mldclim[-1]
        dmld = mld - mld_prev
        zt = self.z_topo
        m = (zt < 0.0) & (ts >= p.To_ice2) & (dmld < 0.0)
        dTo[m] = -dmld[m] / (self.z_ocean[m] - mld[m]) * (ts[m] - to[m])
        m = (zt < 0.0) & (ts >= p.To_ice2) & (dmld > 0.0)
        dT_ocean[m] = dmld[m] / mld[m] * (to[m] - ts[m])
        c_effmix = F32(0.5)
        dTo = c_effmix * dTo
        dT_ocean = c_effmix * dT_ocean
        tx = np.maximum(p.To_ice2, ts)
        dTo = dTo + F32(self.dt) * p.co_turb * (tx - to) / (
            self.cap_ocean * (self.z_ocean - mld))
        dT_ocean = dT_ocean + F32(self.dt) * p.co_turb * (to - tx) / (
            self.cap_ocean * mld)
        return dT_ocean.astype(F32), dTo.astype(F32)

    # -- stencils (literal row loops) ----------------------------------------
    def diffusion(self, t1, wz):
        """src/greb.f90:556-723"""
        p = self.p
        x, y = self.xdim, self.ydim
        dtc = F32(self.dt_crcl)
        ccy = p.kappa * dtc / self.dyy ** 2
        ccx = p.kappa * dtc / self.dxlat ** 2
        dTy = np.zeros((y, x), F32)
        dTx = np.zeros((y, x), F32)
        for k in range(y):
            km1, kp1 = k - 1, k + 1
            if 1 <= k <= y - 2:
                dTy[k] = ccy * (wz[km1] * (t1[km1] - t1[k])
                                + wz[kp1] * (t1[kp1] - t1[k]))
            elif k == 0:
                dTy[k] = ccy * wz[kp1] * (-t1[k] + t1[kp1])
            else:
                dTy[k] = ccy * wz[km1] * (t1[km1] - t1[k])
            if self.dxlat[k] > F32(2.5e5):
                dTx[k] = self._diff7_row(t1[k], wz[k], ccx[k])
            else:
                dd = max(1, nint(float(dtc / (F32(1.0) * self.dxlat[k] ** 2
                                              / p.kappa))))
                dtdff2 = self.dt_crcl // dd
                time2 = max(1, nint(float(dtc) / float(dtdff2)))
                ccx2 = p.kappa * F32(dtdff2) / self.dxlat[k] ** 2
                t1h = t1[k].copy()
                for _ in range(time2):
                    dTxh = self._diff7_row(t1h, wz[k], ccx2)
                    m = dTxh <= -t1h
                    dTxh[m] = F32(-0.9) * t1h[m]  # clamp (:715)
                    t1h = t1h + dTxh
                dTx[k] = t1h - t1[k]
        return (wz * (dTx + dTy)).astype(F32)

    @staticmethod
    def _diff7_row(t, w, cc):
        r = lambda a, s: np.roll(a, s)
        tm1, tm2, tm3 = r(t, 1), r(t, 2), r(t, 3)
        tp1, tp2, tp3 = r(t, -1), r(t, -2), r(t, -3)
        wm1, wm2, wm3 = r(w, 1), r(w, 2), r(w, 3)
        wp1, wp2, wp3 = r(w, -1), r(w, -2), r(w, -3)
        return (cc * (F32(10.0) * (wm1 * (tm1 - t) + wp1 * (tp1 - t))
                      + F32(4.0) * (wm2 * (tm2 - tm1) + wm1 * (t - tm1))
                      + F32(4.0) * (wp1 * (t - tp1) + wp2 * (tp2 - tp1))
                      + F32(1.0) * (wm3 * (tm3 - tm2) + wm2 * (tm1 - tm2))
                      + F32(1.0) * (wp2 * (tp1 - tp2) + wp3 * (tp3 - tp2)))
                / F32(20.0)).astype(F32)

    def advection(self, t1, wz, ityr):
        """src/greb.f90:726-915 (incl. the jp2 quirk at :881)"""
        x, y = self.xdim, self.ydim
        dtc = F32(self.dt_crcl)
        ccy = dtc / self.dyy / F32(2.0)
        ccx = dtc / self.dxlat / F32(2.0)
        vm, vp = self.vclim_m[ityr], self.vclim_p[ityr]
        um, up = self.uclim_m[ityr], self.uclim_p[ityr]
        dTy = np.zeros((y, x), F32)
        dTx = np.zeros((y, x), F32)

        # meridional (:756-795)
        k = 0
        dTy[k] = ccy * (vp[k] * (wz[k + 1] * (t1[k] - t1[k + 1])
                                 + wz[k + 2] * (t1[k] - t1[k + 2]))) / F32(3.0)
        k = 1
        dTy[k] = ccy * (-vm[k] * (wz[k - 1] * (t1[k] - t1[k - 1]))
                        + vp[k] * (wz[k + 1] * (t1[k] - t1[k + 1])
                                   + wz[k + 2] * (t1[k] - t1[k + 2])) / F32(3.0))
        for k in range(2, y - 2):
            dTy[k] = ccy * (-vm[k] * (wz[k - 1] * (t1[k] - t1[k - 1])
                                      + wz[k - 2] * (t1[k] - t1[k - 2]))
                            + vp[k] * (wz[k + 1] * (t1[k] - t1[k + 1])
                                       + wz[k + 2] * (t1[k] - t1[k + 2]))) / F32(3.0)
        k = y - 2
        dTy[k] = ccy * (-vm[k] * (wz[k - 1] * (t1[k] - t1[k - 1])
                                  + wz[k - 2] * (t1[k] - t1[k - 2])) / F32(3.0)
                        + vp[k] * (wz[k + 1] * (t1[k] - t1[k + 1])))
        k = y - 1
        dTy[k] = ccy * (-vm[k] * (wz[k - 1] * (t1[k] - t1[k - 1])
                                  + wz[k - 2] * (t1[k] - t1[k - 2]))) / F32(3.0)

        # zonal (:798-911)
        for k in range(y):
            if self.dxlat[k] > F32(2.5e5):
                t, w = t1[k], wz[k]
                r = lambda a, s: np.roll(a, s)
                dTx[k] = ccx[k] * (
                    -um[k] * (r(w, 1) * (t - r(t, 1)) + r(w, 2) * (t - r(t, 2)))
                    + up[k] * (r(w, -1) * (t - r(t, -1))
                               + r(w, -2) * (t - r(t, -2)))) / F32(3.0)
            else:
                dd = max(1, nint(float(dtc / (self.dxlat[k] / F32(10.0)
                                              / F32(1.0)))))
                dtdff2 = self.dt_crcl // dd
                time2 = max(1, nint(float(dtc) / float(dtdff2)))
                ccx2 = F32(dtdff2) / self.dxlat[k] / F32(2.0)
                # index vectors with the reference's jp2 quirk (:881)
                j = np.arange(x)
                jm1, jm2, jm3 = (j - 1) % x, (j - 2) % x, (j - 3) % x
                jp1, jp2, jp3 = (j + 1) % x, (j + 2) % x, (j + 3) % x
                jp2[x - 3] = x - 2   # Fortran j=xdim-2: jp2=xdim-1 (not xdim)
                t1h = t1[k].copy()
                w = wz[k]
                for _ in range(time2):
                    dTxh = ccx2 * (
                        -um[k] * (F32(10.0) * w[jm1] * (t1h - t1h[jm1])
                                  + F32(4.0) * w[jm2] * (t1h[jm1] - t1h[jm2])
                                  + F32(1.0) * w[jm3] * (t1h[jm2] - t1h[jm3]))
                        + up[k] * (F32(10.0) * w[jp1] * (t1h - t1h[jp1])
                                   + F32(4.0) * w[jp2] * (t1h[jp1] - t1h[jp2])
                                   + F32(1.0) * w[jp3] * (t1h[jp2] - t1h[jp3]))
                    ) / F32(20.0)
                    m = dTxh <= -t1h
                    dTxh[m] = F32(-0.9) * t1h[m]  # clamp (:907)
                    t1h = t1h + dTxh
                dTx[k] = t1h - t1[k]
        return (dTx + dTy).astype(F32)

    def circulation(self, x_in, wz, h_scl_is_vapor, ityr):
        """src/greb.f90:528-553 + legacy gates (greb.original.model.f90:553-565)"""
        e = self.log_exp
        if e is not None:
            if e <= 4:
                return np.zeros_like(x_in)
            if h_scl_is_vapor and e in (7, 16):
                return np.zeros_like(x_in)
        time = max(1, nint(float(F32(self.dt)) / self.dt_crcl))
        x = x_in.copy()
        diffusion_only = (e == 8 and h_scl_is_vapor) if e is not None else False
        for _ in range(time):
            dxd = self.diffusion(x, wz)
            if diffusion_only:
                x = x + dxd
            else:
                dxa = self.advection(x, wz, ityr)
                x = x + dxd + dxa
        return (x - x_in).astype(F32)

    # -- tendencies + steps ---------------------------------------------------
    def tendencies(self, st, co2, ityr):
        """src/greb.f90:277-308"""
        p = self.p
        sw, albedo = self.sw_radiation(st["ts"], ityr)
        lw_surf, lwup, lwdn, em = self.lw_radiation(st["ts"], st["ta"],
                                                    st["q"], co2, ityr)
        q_sens = p.ct_sens * (st["ta"] - st["ts"])
        q_lat, q_lat_air, dq_eva, dq_rain = self.hydro(st["ts"], st["q"], ityr)
        dta_crcl = self.circulation(st["ta"], self.wz_air, False, ityr)
        dq_crcl = self.circulation(st["q"], self.wz_vapor, True, ityr)
        dT_ocean, dTo = self.deep_ocean(st["ts"], st["to"], ityr)
        return dict(sw=sw, albedo=albedo, lw_surf=lw_surf, lwair_up=lwup,
                    lwair_down=lwdn, em=em, q_sens=q_sens, q_lat=q_lat,
                    q_lat_air=q_lat_air, dq_eva=dq_eva, dq_rain=dq_rain,
                    dta_crcl=dta_crcl, dq_crcl=dq_crcl, dT_ocean=dT_ocean,
                    dTo=dTo)

    def scenario_step(self, st, co2, ityr, corr):
        """src/greb.f90:239-274"""
        if self.log_exp is not None and 14 <= self.log_exp <= 16:
            m = self.z_topo < 0.0
            st = dict(st)
            ts = st["ts"].copy()
            ts[m] = self.tclim[ityr][m] + F32(1.0)
            st["ts"] = ts
        t = self.tendencies(st, co2, ityr)
        dt = F32(self.dt)
        ts0 = st["ts"] + t["dT_ocean"] + dt * (
            t["sw"] + t["lw_surf"] - t["lwair_down"] + t["q_lat"]
            + t["q_sens"] + corr["tf"][ityr]) / self.cap_surf
        ta0 = st["ta"] + t["dta_crcl"] + dt * (
            t["lwair_up"] + t["lwair_down"] - t["em"] * t["lw_surf"]
            + t["q_lat_air"] - t["q_sens"]) / self.cap_air
        to0 = st["to"] + t["dTo"] + corr["tof"][ityr]
        dq = dt * (t["dq_eva"] + t["dq_rain"]) + t["dq_crcl"] + corr["qf"][ityr]
        m = dq <= -st["q"]
        dq[m] = F32(-0.9) * st["q"][m]
        q0 = st["q"] + dq
        self.seaice(ts0, ityr)
        new = dict(ts=ts0.astype(F32), ta=ta0.astype(F32),
                   to=to0.astype(F32), q=q0.astype(F32))
        return new, t

    def fluxcorr_step(self, st, co2, ityr, corr):
        """src/greb.f90:325-361; writes corr tables in place."""
        t = self.tendencies(st, co2, ityr)
        dt = F32(self.dt)
        dts = dt * (t["sw"] + t["lw_surf"] - t["lwair_down"] + t["q_lat"]
                    + t["q_sens"]) / self.cap_surf
        ts0 = st["ts"] + dts + t["dT_ocean"]
        dta = dt * (t["lwair_up"] + t["lwair_down"] - t["em"] * t["lw_surf"]
                    + t["q_lat_air"] - t["q_sens"]) / self.cap_air
        ta0 = st["ta"] + dta + t["dta_crcl"]
        to0 = st["to"] + t["dTo"]
        dq = dt * (t["dq_eva"] + t["dq_rain"])
        q0 = st["q"] + dq + t["dq_crcl"]

        t_err = self.tclim[ityr] - ts0
        corr["tf"][ityr] = t_err * self.cap_surf / dt
        ts0 = st["ts"] + dts + t["dT_ocean"] + corr["tf"][ityr] * dt / self.cap_surf
        corr["tof"][ityr] = self.toclim - to0
        to0 = st["to"] + t["dTo"] + corr["tof"][ityr]
        corr["qf"][ityr] = self.qclim[ityr] - q0
        q0 = st["q"] + dq + t["dq_crcl"] + corr["qf"][ityr]
        self.seaice(ts0, ityr)
        return dict(ts=ts0.astype(F32), ta=ta0.astype(F32),
                    to=to0.astype(F32), q=q0.astype(F32))

    def zero_corrections(self):
        z = lambda: np.zeros((self.nstep_yr, self.ydim, self.xdim), F32)
        return dict(tf=z(), tof=z(), qf=z())
