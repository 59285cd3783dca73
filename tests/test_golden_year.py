"""Config-1 golden year at 96x48 against the NumPy oracle — POLAR ROWS
INCLUDED (step-level tests mask them near the clamp knife-edge; this test
proves year-scale fidelity on the full grid).

The golden artifact (tests/golden/golden_year_96x48.npz) is the oracle's
(line-by-line src/greb.f90 transliteration) trajectory for 1 flux-correction
year (co2=298) + 1 scenario year (co2=680) on the deterministic synthetic
forcing: monthly means of the 5 output variables (src/greb.f90:962-987),
the end-of-phase states, and correction-table annual means.  Regenerate
with ``python tools/make_golden.py`` (~17 min pure NumPy); the slow marker
below re-derives it live when GREB_SLOW=1.
"""
import os

import numpy as np
import pytest

from greb_tpu.config import GrebConfig, Numerics
from greb_tpu.forcing import forcing_from_arrays
from greb_tpu.io.synthetic import make_synthetic_forcing
from greb_tpu.model.driver import GREB

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_year_96x48.npz")

# Monthly means after 730+730 steps: temperatures agree to mK; q to ~1e-6
# absolute (field scale ~1e-2); albedo to ~1e-4.  The fast paths regroup
# float32 sums, so tolerances cover accumulation-order noise too.
TOL = {"ts": 2e-2, "ta": 2e-2, "to": 2e-2, "q": 3e-6, "albedo": 5e-4}


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def forcing96():
    return forcing_from_arrays(make_synthetic_forcing(96, 48, 730))


def run_golden_year(forcing, **cfg_kw):
    num = Numerics(time_flux=1, time_scnr=1)
    m = GREB(GrebConfig(numerics=num, **cfg_kw), forcing=forcing,
             verbose=False)
    state_fc, corr = m.flux_correction(co2=298.0)
    # the scenario continues from the spin-up end state (reference module
    # arrays persist across phases; Ta in particular is not pinned)
    state, monthly, _ = m.run_scenario(
        corr, state=state_fc, co2_series=np.full(1, 680.0, np.float32))
    return m, state_fc, corr, state, monthly[0]


def golden_checks(golden, state_fc, corr, state, monthly):
    """[(name, max |got - golden|, absolute bound)] for every compared
    quantity; cap_surf's bound is relative (max |got/golden - 1|)."""
    checks = []

    def add(name, got, want, bound):
        d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
        checks.append((name, float(d.max()), bound))

    # flux-correction year pins the end state to the oracle's
    for k, g in (("ts", "fc_ts"), ("ta", "fc_ta"), ("to", "fc_to")):
        add(g, getattr(state_fc, k), golden[g], 2e-2)
    add("fc_q", state_fc.q, golden["fc_q"], 3e-6)
    rel = np.abs(np.asarray(state_fc.cap_surf, np.float64)
                 / golden["fc_cap_surf"] - 1.0)
    checks.append(("fc_cap_surf(rel)", float(rel.max()), 1e-5))
    # correction-table annual means (ftmn/fqmn analog)
    add("corr_tf_mean", np.asarray(corr.tf).mean(axis=0),
        golden["corr_tf_mean"], 1.0)
    add("corr_qf_mean", np.asarray(corr.qf).mean(axis=0),
        golden["corr_qf_mean"], 1e-7)
    # scenario-year monthly means, all 12 months, ALL rows incl. poles
    got = np.asarray(monthly)                      # (12, 5, 48, 96)
    for v, name in enumerate(("ts", "ta", "to", "q", "albedo")):
        add("monthly_" + name, got[:, v], golden["monthly"][:, v], TOL[name])
    # end-of-scenario state
    for k, g in (("ts", "end_ts"), ("ta", "end_ta"), ("to", "end_to")):
        add(g, getattr(state, k), golden[g], 3e-2)
    add("end_q", state.q, golden["end_q"], 5e-6)
    return checks


@pytest.mark.parametrize("cfg", [dict(fast_circulation=False),
                                 dict(fast_circulation=True)],
                         ids=["strict", "fast-v2"])
def test_golden_year_monthly_means(golden, forcing96, cfg):
    m, state_fc, corr, state, monthly = run_golden_year(forcing96, **cfg)
    for name, d, bound in golden_checks(golden, state_fc, corr, state,
                                        monthly):
        assert d <= bound, (name, d, bound)


@pytest.mark.skipif(not os.environ.get("GREB_SLOW"),
                    reason="oracle regeneration takes ~17 min (GREB_SLOW=1)")
def test_golden_artifact_matches_live_oracle(golden):
    """Re-derive the artifact from the oracle and compare bit-for-bit —
    proves the committed golden file is what tools/make_golden.py produces."""
    import subprocess
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        repo = os.path.join(os.path.dirname(__file__), "..")
        env = dict(os.environ, GREB_GOLDEN_OUT=os.path.join(td, "g.npz"))
        # the script writes to tests/golden; run it in a scratch checkout of
        # just the needed inputs by overriding cwd-relative output
        subprocess.run([sys.executable, "tools/make_golden.py"],
                       cwd=repo, check=True, env=env)
        fresh = np.load(os.path.join(repo, "tests/golden",
                                     "golden_year_96x48.npz"))
        for k in golden.files:
            np.testing.assert_array_equal(golden[k], fresh[k], err_msg=k)
