"""Tests for the analysis layer (R-equivalent), diag subsystem, and CLI."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from greb_tpu import analysis
from greb_tpu.diag.profiling import (PhaseStats, RunMetrics, check_finite,
                                     phase_timer)
from greb_tpu.io.binio import OutputWriter

F32 = np.float32


@pytest.fixture()
def output_file(tmp_path):
    """A synthetic 2-year output stream with known content."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "scenario")
    w = OutputWriter(path, 96, 48)
    months = rng.uniform(250, 300, size=(24, 5, 48, 96)).astype(F32)
    months[:, 4] = rng.uniform(0.1, 0.8, size=(24, 48, 96))  # albedo
    w.write_months(months)
    w.close()
    return path, months


def test_read_greb_matches_written(output_file):
    path, months = output_file
    sel, data = analysis.read_greb(path, "tocean")
    np.testing.assert_array_equal(data, months[:, 2])
    sel, data = analysis.read_greb(path, "albedo", months=[3, 17])
    np.testing.assert_array_equal(data[0], months[3, 4])
    np.testing.assert_array_equal(data[1], months[17, 4])


def test_read_greb_tidy(output_file):
    path, months = output_file
    df = analysis.read_greb(path, "tsurf", months=[0], tidy=True)
    assert set(df) == {"time", "lon", "lat", "value"}
    assert len(df["value"]) == 48 * 96
    np.testing.assert_array_equal(
        df["value"].reshape(48, 96), months[0, 0])
    # first cell centre (R/functions.R:46-51)
    assert df["lon"][0] == pytest.approx(360.0 / 96 / 2)
    assert df["lat"][0] == pytest.approx(-90 + 180.0 / 48 / 2)


def test_wrap_lon_roundtrip():
    lon = np.array([0.0, 90.0, 180.0, 270.0, 359.0])
    w = analysis.wrap_lon(lon, "180")
    np.testing.assert_allclose(w, [0, 90, -180, -90, -1])
    np.testing.assert_allclose(analysis.wrap_lon(w, "360"), lon % 360)


def test_global_mean_series(output_file):
    path, months = output_file
    gm = analysis.global_mean_series(path, "tsurf", annual=True,
                                     celsius=False)
    want = months[:, 0].mean(axis=(-2, -1)).reshape(2, 12).mean(axis=1)
    np.testing.assert_allclose(gm, want, rtol=1e-6)
    gmw = analysis.global_mean_series(path, "tsurf", annual=False,
                                      weighted=True, celsius=False)
    assert gmw.shape == (24,)
    assert np.isfinite(gmw).all()


def test_area_weights_normalized():
    w = analysis.area_weights(48)
    assert w.sum() == pytest.approx(1.0, rel=1e-6)
    assert w[24] > w[0]  # equator heavier than pole


def test_arctic_september_albedo(output_file):
    path, months = output_file
    out = analysis.arctic_september_albedo(path, years=[0, 1])
    _, lat = analysis.cell_lonlat()
    nrows = int((lat >= 50.0).sum())
    assert out[0].shape == (nrows, 96)
    np.testing.assert_array_equal(out[1], months[20, 4][lat >= 50.0])


def test_monthly_wind_means():
    u = np.ones((730, 48, 96), F32)
    u[:62] = 2.0  # first month (31 days x 2 steps)
    v = np.zeros_like(u)
    mu, mv = analysis.monthly_wind_means(
        u, v, (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31), 2)
    assert mu.shape == (12, 48, 96)
    np.testing.assert_allclose(mu[0], 2.0)
    np.testing.assert_allclose(mu[1], 1.0)


# --- diag ------------------------------------------------------------------
def test_phase_timer_and_stats():
    from greb_tpu.config import Numerics
    num = Numerics()
    with phase_timer("x", sim_years=2, num=num) as t:
        pass
    assert t.stats.wall_s >= 0
    assert t.stats.grid_points == 96 * 48
    s = PhaseStats("y", wall_s=2.0, sim_years=4, grid_points=10,
                   steps_per_year=100)
    assert s.sim_yr_per_s == 2.0
    assert s.point_steps_per_s == 2000.0


def test_check_finite_raises():
    import jax.numpy as jnp
    good = {"a": jnp.ones((4,)), "b": jnp.zeros((2, 2))}
    check_finite(good)  # no raise
    bad = {"a": jnp.ones((4,)), "b": jnp.array([1.0, np.nan])}
    with pytest.raises(FloatingPointError, match="b"):
        check_finite(bad)


def test_run_metrics_roundtrip(tmp_path):
    m = RunMetrics()
    m.log_year(1941, 680.0, 288.5, 0.25, extra_field=1)
    m.log_year(1942, 680.0, 288.7, 0.24)
    p = str(tmp_path / "metrics.jsonl")
    m.save(p)
    back = RunMetrics.load(p)
    assert back.records[0]["year"] == 1941
    assert back.records[0]["extra_field"] == 1
    assert back.records[1]["global_mean_ts"] == pytest.approx(288.7)


# --- CLI -------------------------------------------------------------------
def test_cli_help_and_missing_namelist():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "greb_tpu", "--help"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0
    assert "GREB climate model in JAX" in r.stdout
    r = subprocess.run([sys.executable, "-m", "greb_tpu", "/no/such.nml"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 2
    assert "namelist not found" in r.stderr


def test_summarize_device_lines():
    """Trace reduction behind tools/trace_xla.py: kernels and copies count
    on stream lines only, a copy's kind comes from the trace's copy event
    names (a kernel named like a copy stays a kernel), and busy time is the
    union of overlapping intervals."""
    from greb_tpu.diag.profiling import summarize_device_lines
    lines = {
        "Stream #13(Memset,Compute)": [
            ("fusion_1", 0, 10), ("fusion_2", 5, 20),
            ("memcpy32_post", 20, 22), ("Memset 0", 22, 23),
            ("MemcpyDtoH", 30, 35)],
        "Stream #14(MemcpyH2D)": [("MemcpyH2D", 40, 50)],
        "XLA Ops": [("fusion_1", 0, 10)],
    }
    s = summarize_device_lines(lines)
    assert s["lines"] == {"Stream #13(Memset,Compute)": 5,
                          "Stream #14(MemcpyH2D)": 1, "XLA Ops": 1}
    assert s["kernels"] == 3
    assert s["copies"] == {"memset": 1, "d2h": 1, "h2d": 1}
    assert s["copy_names"] == {
        "memcpy32_post": {"kind": "kernel", "count": 1},
        "Memset 0": {"kind": "memset", "count": 1},
        "MemcpyDtoH": {"kind": "d2h", "count": 1},
        "MemcpyH2D": {"kind": "h2d", "count": 1}}
    assert s["busy_ns"] == 23 + 5 + 10
    assert s["window_ns"] == 50
    assert summarize_device_lines({})["busy_ns"] == 0


def test_summarize_host_lines():
    """Host calls behind tools/trace_xla.py's host-wait verdict: graph
    launches, while-loop thunks, synchronisations and device-to-host
    copies, each with the event names that matched."""
    from greb_tpu.diag.profiling import summarize_host_lines
    lines = {
        "/host:CPU/python": [
            ("cuGraphLaunch (CudaGraph:17)", 0, 1),
            ("cuGraphLaunch (CudaGraph:17)", 2, 3), ("while.5", 0, 4),
            ("command_buffer", 0, 1), ("cuStreamSynchronize", 5, 6)],
        "/host:CPU/pjrt_async_work_runner/1": [("MemcpyH2D", 0, 1),
                                               ("MemcpyD2H", 1, 2)],
    }
    s = summarize_host_lines(lines)
    assert (s["graph_launch"], s["while_thunk"], s["sync"], s["d2h"],
            s["kernel_launch"]) == (2, 1, 1, 1, 0)
    assert s["names"] == {"cuGraphLaunch (CudaGraph:17)": 2, "while.5": 1,
                          "cuStreamSynchronize": 1, "MemcpyD2H": 1}

