"""Rehearsal of chip_smoke.py on the CPU: its device check refuses the CPU,
and the phase functions run end to end here with fewer years and members
(the four-card phases on the 8 virtual CPU devices, at reduced calendars).
The golden-year phase is two calls of tests/test_golden_year.py's own
functions and is covered there.  The GPU itself is exercised by
``python chip_smoke.py`` on the card."""
import chip_smoke


def test_chip_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert out == ""                      # no result line
    assert "no GPU" in err


def test_rehearse_cli(tmp_path):
    res = chip_smoke.phase_cli(str(tmp_path), flux=1, scnr=1)
    assert res["months"] == 12
    assert res["sim_yr_per_s"] > 0


def test_rehearse_resume(tmp_path):
    assert chip_smoke.phase_resume(str(tmp_path), flux=1, scnr=2)["bitexact"]


def test_rehearse_ensemble(tmp_path):
    res = chip_smoke.phase_ensemble(str(tmp_path), members=2)
    assert res["cli_highest_monthly_max"] < 5e-3
    assert set(res["high"]) >= {"monthly_max", "monthly_rms", "end_ts_max"}


def test_rehearse_four_card_phases(need_devices):
    need_devices(4)
    assert chip_smoke.phase_halo(rows=48, cols=96)["bitexact"]
    res = chip_smoke.phase_members_mesh(num_kw=dict(ndays_yr=10,
                                                    jday_mon=(6, 4)))
    assert res["monthly_max"] < 2e-2
    res = chip_smoke.phase_refined_mesh(num_kw=dict(ndays_yr=2,
                                                    jday_mon=(2,)))
    assert res["unsharded"]["end_ts_max"] < 5e-2
    assert res["emulated"]["monthly_max"] == 0.0     # bit for bit here
