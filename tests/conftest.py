import os
import subprocess

import jax
import numpy as np
import pytest


def pytest_configure(config):
    """Build the native C++ record-IO library so binio and
    test_native_matches_numpy exercise the fast path (gcc is a baked-in
    tool; the .so is gitignored).  Best-effort: the NumPy fallback keeps
    everything green if no compiler is present."""
    native_dir = os.path.join(os.path.dirname(__file__), "..", "greb_tpu",
                              "native")
    try:
        subprocess.run(["make", "-C", native_dir, "-s"], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        pass

from greb_tpu.config import Experiment, GrebConfig, Numerics, PhysicsParams
from greb_tpu.forcing import (build_derived, forcing_from_arrays,
                              initial_state)
from greb_tpu.grid import make_grid
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model import core
from greb_tpu.ops import stencils as stc
from tests.oracle.greb_oracle import GrebOracle, OracleParams


@pytest.fixture(scope="session")
def forcing_np():
    return make_synthetic_forcing(96, 48, 730)


class Setup:
    """Bundles the jax-side model pieces with the numpy oracle."""

    def __init__(self, forcing_np, log_exp=None):
        self.num = Numerics(time_flux=1, time_scnr=1)
        self.exp = Experiment(log_exp=log_exp)
        self.params = PhysicsParams.default()
        self.oracle = GrebOracle(forcing_np, OracleParams(), log_exp=log_exp)
        # the oracle applies legacy field overrides internally; mirror them
        # on the jax side through apply_experiment
        from greb_tpu.forcing import apply_experiment
        self.forcing = apply_experiment(forcing_from_arrays(forcing_np),
                                        self.params, self.exp)
        self.grid = make_grid(self.num.xdim, self.num.ydim, self.num.dt_crcl)
        self.st, sf_np = stc.make_stencil_arrays(self.grid)
        self.sf = jax.tree.map(jax.numpy.asarray, sf_np)
        self.derived = build_derived(self.params, self.forcing)
        self.md = core.ModelData(params=self.params, derived=self.derived,
                                 z_topo=self.forcing.z_topo,
                                 glacier=self.forcing.glacier, sf=self.sf)
        self.sfx = core.step_forcing_from_clim(self.forcing)

    def state0(self):
        return initial_state(self.params, self.forcing, self.derived)

    def fx(self, ityr):
        return jax.tree.map(lambda a: a[ityr], self.sfx)


@pytest.fixture(scope="session")
def setup(forcing_np):
    return Setup(forcing_np)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run only where JAX's first device is a GPU;
    decided here, at run time, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            pytest.skip(f"needs an NVIDIA GPU; JAX has {dev.platform} "
                        f"(run: JAX_PLATFORMS=cuda python -m pytest -m gpu)")


@pytest.fixture
def need_devices():
    """need_devices(n) skips the test when JAX has fewer than n devices
    (the root conftest gives the CPU 8 virtual ones)."""
    def need(n: int) -> None:
        if len(jax.devices()) < n:
            pytest.skip(f"needs {n} devices, JAX has {len(jax.devices())}")
    return need


@pytest.fixture(autouse=True)
def _restore_oracle_state(request):
    """The oracle mimics Fortran module state (cap_surf mutated by seaice);
    isolate tests from each other."""
    if "setup" in request.fixturenames:
        s = request.getfixturevalue("setup")
        cap = s.oracle.cap_surf.copy()
        yield
        s.oracle.cap_surf = cap
    else:
        yield


def assert_close(a, b, rtol=2e-5, atol=1e-6, name=""):
    a = np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
