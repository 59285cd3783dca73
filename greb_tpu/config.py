"""Configuration system for the GREB framework.

Mirrors the reference Fortran namelist groups (numerics_par, physics_par,
co2_par, diagnostics_par; cf. reference src/greb.f90:32-158 and
doc/namelist.md) as JAX-friendly dataclasses:

- ``Numerics``     : static (trace-time) integers/floats that fix array shapes
                     and scan lengths. Never traced.
- ``PhysicsParams``: a registered pytree of float32 leaves. Every physical
                     "constant" is a traced leaf so whole-model ensembles can
                     be expressed as ``jax.vmap`` over a stacked params pytree
                     (one perturbed member per batch entry).
- ``Diagnostics``  : output file naming / diagnostic point.
- ``CO2Params``    : CO2 pathway (flux-correction level + scenario series).
- ``Experiment``   : static process-control switches replicating the legacy
                     variant's ``log_exp`` 0-16 switchboard
                     (reference src/greb.original.model.f90:60,162-166 etc).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import jax
import numpy as np

from ._pytree import pytree_dataclass

F32 = np.float32


# ---------------------------------------------------------------------------
# Static numerics (shapes / scan lengths).  Reference: src/greb.f90:32-57.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Numerics:
    xdim: int = 96                 # number of longitudes
    ydim: int = 48                 # number of latitudes
    ndays_yr: int = 365            # days per year
    dt: int = 12 * 3600            # model time step [s]
    dt_crcl: int = 1800            # circulation time step [s]
    jday_mon: Tuple[int, ...] = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
    ireal: int = 4                 # record word length [bytes]

    # run control (namelist numerics_par)
    time_flux: int = 0             # flux-correction phase length [yr]
    time_ctrl: int = 0             # control phase length [yr] (legacy variant)
    time_scnr: int = 0             # scenario phase length [yr]
    ipx: int = 1                   # diagnostic point, x (1-based, as Fortran)
    ipy: int = 1                   # diagnostic point, y (1-based)
    year0: int = 1940              # scenario start year

    @property
    def ndt_days(self) -> int:
        return 24 * 3600 // self.dt

    @property
    def nstep_yr(self) -> int:
        return self.ndays_yr * self.ndt_days

    @property
    def dlon(self) -> float:
        return 360.0 / self.xdim

    @property
    def dlat(self) -> float:
        return 180.0 / self.ydim

    @property
    def nsub_crcl(self) -> int:
        """Circulation substeps per model step (reference src/greb.f90:543)."""
        return max(1, int(round(float(self.dt) / self.dt_crcl)))

    def validate(self) -> "Numerics":
        assert self.xdim >= 8 and self.ydim >= 6, "grid too small for stencils"
        assert sum(self.jday_mon) == self.ndays_yr
        assert 24 * 3600 % self.dt == 0, "dt must divide a day"
        return self


# ---------------------------------------------------------------------------
# Physics parameters: a pytree of float32 scalars (vmappable).
# Reference defaults: src/greb.f90:68-101.
# ---------------------------------------------------------------------------
@pytree_dataclass
class PhysicsParams:
    # natural constants
    pi: jax.Array        # 3.1416 in the reference (used in grid metrics)
    sig: jax.Array       # Stefan-Boltzmann [W/m^2/K^4]
    rho_ocean: jax.Array
    rho_land: jax.Array
    rho_air: jax.Array
    cp_ocean: jax.Array
    cp_land: jax.Array
    cp_air: jax.Array
    eps: jax.Array
    # model parameters
    d_ocean: jax.Array
    d_land: jax.Array
    d_air: jax.Array
    ct_sens: jax.Array
    da_ice: jax.Array
    a_no_ice: jax.Array
    a_cloud: jax.Array
    Tl_ice1: jax.Array
    Tl_ice2: jax.Array
    To_ice1: jax.Array
    To_ice2: jax.Array
    co_turb: jax.Array
    kappa: jax.Array
    ce: jax.Array
    cq_latent: jax.Array
    cq_rain: jax.Array
    z_air: jax.Array
    z_vapor: jax.Array
    r_qviwv: jax.Array
    c_effmix: jax.Array  # deep-ocean mixing efficiency (0.5, src/greb.f90:516)
    p_emi: jax.Array     # (10,) emissivity fit parameters

    @classmethod
    def default(cls) -> "PhysicsParams":
        f = lambda x: np.float32(x)
        return cls(
            pi=f(3.1416),
            sig=f(5.6704e-8),
            rho_ocean=f(999.1),
            rho_land=f(2600.0),
            rho_air=f(1.2),
            cp_ocean=f(4186.0),
            cp_land=f(926.222),
            cp_air=f(1005.0),
            eps=f(1.0),
            d_ocean=f(50.0),
            d_land=f(2.0),
            d_air=f(5000.0),
            ct_sens=f(22.5),
            da_ice=f(0.25),
            a_no_ice=f(0.1),
            a_cloud=f(0.35),
            Tl_ice1=f(273.15 - 10.0),
            Tl_ice2=f(273.15),
            To_ice1=f(273.15 - 7.0),
            To_ice2=f(273.15 - 1.7),
            co_turb=f(5.0),
            kappa=f(8e5),
            ce=f(2e-3),
            cq_latent=f(2.257e6),
            cq_rain=f(np.float32(-0.1) / F32(24.0) / F32(3600.0)),
            z_air=f(8400.0),
            z_vapor=f(5000.0),
            r_qviwv=f(2.6736e3),
            c_effmix=f(0.5),
            p_emi=np.asarray(
                [9.0721, 106.7252, 61.5562, 0.0179, 0.0028,
                 0.0570, 0.3462, 2.3406, 0.7032, 1.0662], dtype=F32),
        )

    def replace(self, **kw) -> "PhysicsParams":
        return dataclasses.replace(self, **{k: np.float32(v) if np.isscalar(v) else np.asarray(v, F32)
                                            for k, v in kw.items()})


# ---------------------------------------------------------------------------
# Diagnostics / output naming. Reference: src/greb.f90:139-158.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Diagnostics:
    output_file: str = "output/scenario"
    ens_id: str = ""
    console: bool = True      # print annual means like the reference
    store_monthly: bool = True

    @property
    def output_file_full(self) -> str:
        return self.output_file if not self.ens_id else f"{self.output_file}_{self.ens_id}"


# ---------------------------------------------------------------------------
# CO2 pathway. Reference: src/greb.f90:104-105, 918-926, 1046-1061.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CO2Params:
    co2_flux: float = 298.0          # level during the flux-correction phase
    co2_ppm: Tuple[float, ...] = ()  # scenario series (one value per year)

    def series(self, time_scnr: int) -> np.ndarray:
        """Pad the annual series per the reference semantics
        (src/greb.f90:1053-1061): empty -> constant 680; negatives replaced
        by the last positive value."""
        out = np.full((max(time_scnr, 1),), -1.0, dtype=F32)
        vals = np.asarray(self.co2_ppm, dtype=F32)
        out[: min(len(vals), len(out))] = vals[: len(out)]
        if len(out) and out[0] < 0:
            out[0] = 680.0
        for i in range(1, len(out)):
            if out[i] < 0:
                out[i:] = out[i - 1]
                break
        return out


# ---------------------------------------------------------------------------
# Legacy experiment switchboard. Reference: src/greb.original.model.f90.
# ``log_exp`` is STATIC: it changes the traced program structure.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Experiment:
    log_exp: Optional[int] = None    # None => modernized variant (no switches)

    # --- derived static flags (evaluated at trace time) -------------------
    @property
    def active(self) -> bool:
        return self.log_exp is not None

    def _e(self) -> int:
        return self.log_exp if self.log_exp is not None else 10**9

    @property
    def flat_topo(self) -> bool:            # :162
        return self.active and self._e() == 1

    @property
    def const_cloud(self) -> bool:          # :163
        return self.active and self._e() <= 2

    @property
    def const_vapor(self) -> bool:          # :164
        return self.active and self._e() <= 3

    @property
    def no_deep_ocean_mld(self) -> bool:    # :165-166 (mldclim = d_ocean)
        return self.active and (self._e() <= 9 or self._e() == 11)

    @property
    def fixed_albedo(self) -> bool:         # :394
        return self.active and self._e() <= 5

    @property
    def simple_seaice(self) -> bool:        # :492-496
        return self.active and self._e() <= 5

    @property
    def hydro_off(self) -> bool:            # :453
        return self.active and (self._e() <= 6 or self._e() in (13, 15))

    @property
    def circulation_off(self) -> bool:      # :553
        return self.active and self._e() <= 4

    @property
    def vapor_circulation_off(self) -> bool:  # :554-555 (exp 7 and 16)
        return self.active and self._e() in (7, 16)

    @property
    def vapor_diffusion_only(self) -> bool:  # :560
        return self.active and self._e() == 8

    @property
    def deep_ocean_off(self) -> bool:       # :514-515
        return self.active and (self._e() <= 9 or self._e() == 11
                                or 14 <= self._e() <= 16)

    @property
    def linear_vapor_lw(self) -> bool:      # :423,430
        return self.active and self._e() == 11

    @property
    def a1b_co2(self) -> bool:              # :179, :946
        return self.active and self._e() in (12, 13)

    @property
    def sst_plus_one(self) -> bool:         # :225-226 (exp 14-16)
        return self.active and 14 <= self._e() <= 16

    @property
    def co2_ctrl(self) -> float:            # :178-179
        return 298.0 if self.a1b_co2 else 340.0


# ---------------------------------------------------------------------------
# Top-level bundle
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class GrebConfig:
    numerics: Numerics = field(default_factory=Numerics)
    diagnostics: Diagnostics = field(default_factory=Diagnostics)
    co2: CO2Params = field(default_factory=CO2Params)
    experiment: Experiment = field(default_factory=Experiment)
    # runtime knobs (not in the reference)
    # Statically unrolling the 24 circulation substeps inflates the XLA
    # graph ~24x (CPU compiles of a full year then take minutes); default to
    # a loop and let benchmarks opt in.
    unroll_circulation: bool = False
    # Runtime failure detection (the reference debug build's FPE-trap analog,
    # Makefile:10): check prognostic fields for NaN/Inf every N scenario
    # years (0 = off) and raise FloatingPointError naming the fields.
    check_finite_every: int = 0
    # Coefficient-folded circulation (ops/fastcirc.py): same float32 formulas
    # algebraically regrouped into ~11 fused multiply-adds per substep, with
    # the polar clamp iterations kept exactly.  Matches the strict path to
    # float32 rounding; disabled for legacy transport overrides and for
    # ensembles that perturb transport parameters.
    fast_circulation: bool = False
    # Which fold to use when fast_circulation is on: 2 = the uniform masked
    # fold (ops/fastcirc2.py — fewer, larger vector ops; latitude-shardable),
    # 1 = the banded fold (ops/fastcirc.py).  Both match the strict path to
    # float32 rounding.
    fastcirc_version: int = 2
    fidelity_jp2_quirk: bool = True   # reproduce src/greb.f90:881 index quirk

    def physics_defaults(self) -> PhysicsParams:
        return PhysicsParams.default()


def config_from_namelist(path: str) -> Tuple[GrebConfig, PhysicsParams]:
    """Build (GrebConfig, PhysicsParams) from a Fortran namelist file,
    mirroring PROGRAM greb_run (src/greb.f90:1042-1068)."""
    from .io.namelist import read_namelist

    groups = read_namelist(path)
    phys = dict(groups.get("physics_par", {}))
    num = dict(groups.get("numerics_par", {}))
    diag = dict(groups.get("diagnostics_par", {}))
    co2 = dict(groups.get("co2_par", {}))
    legacy_num = dict(groups.get("numerics", {}))
    legacy_phys = dict(groups.get("physics", {}))

    numerics = Numerics(
        time_flux=int(num.get("time_flux", legacy_num.get("time_flux", 0))),
        time_ctrl=int(legacy_num.get("time_ctrl", 0)),
        time_scnr=int(num.get("time_scnr", legacy_num.get("time_scnr", 0))),
        ipx=int(num.get("ipx", 1)),
        ipy=int(num.get("ipy", 1)),
        year0=int(num.get("year0", 1940)),
    ).validate()

    diagnostics = Diagnostics(
        output_file=str(diag.get("output_file", "output/scenario")),
        ens_id=str(diag.get("ens_id", "")),
    )

    co2_ppm = co2.get("co2_ppm", ())
    if np.isscalar(co2_ppm):
        co2_ppm = (float(co2_ppm),)
    co2_params = CO2Params(
        co2_flux=float(co2.get("co2_flux", 298.0)),
        co2_ppm=tuple(float(v) for v in co2_ppm),
    )

    experiment = Experiment(
        log_exp=int(legacy_phys["log_exp"]) if "log_exp" in legacy_phys else None)

    params = PhysicsParams.default()
    known = {f.name for f in dataclasses.fields(PhysicsParams)}
    overrides = {k: v for k, v in phys.items() if k in known}
    if overrides:
        params = params.replace(**overrides)

    cfg = GrebConfig(numerics=numerics, diagnostics=diagnostics,
                     co2=co2_params, experiment=experiment)
    return cfg, params
