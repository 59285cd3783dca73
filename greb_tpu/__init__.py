"""greb_tpu — a JAX/XLA re-design of the GREB globally-resolved
energy-balance climate model.

Feature-parity target: sieste/greb-climate-model (Fortran 90 reference),
re-architected for accelerators: pure-functional physics ops, ``lax.scan``
time stepping, vmapped ensembles, and ``shard_map`` domain decomposition
with ``ppermute`` halo exchange.
"""
from .config import (CO2Params, Diagnostics, Experiment, GrebConfig, Numerics,
                     PhysicsParams, config_from_namelist)
from .forcing import (ClimForcing, Corrections, Derived, ModelState,
                      build_derived, initial_state, load_forcing,
                      synthetic_forcing)
from .grid import Grid, make_grid
from .model.driver import GREB

__version__ = "0.1.0"

__all__ = [
    "GREB", "GrebConfig", "Numerics", "PhysicsParams", "Diagnostics",
    "CO2Params", "Experiment", "ClimForcing", "Corrections", "Derived",
    "ModelState", "Grid", "make_grid", "build_derived", "initial_state",
    "load_forcing", "synthetic_forcing", "config_from_namelist",
]
