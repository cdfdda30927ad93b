"""`modal_tpu_torch.tools.compare_smoke` reads two `chip_smoke.py --out`
runs and prints each function-calling phase's cold and warm calls side by
side, with the phases' wall times from the runs' logs."""

import json

from modal_tpu_torch.tools import compare_smoke


def _run(scale: float) -> dict:
    return {
        "nvidia_smi": "H100, 700.00 W",
        "worker": {"map_to_output_s": [20.0 * scale, 3.0 * scale]},
        "app": {"warm": {"app_ms": [5.0 * scale, 4.0 * scale, 9.0 * scale]},
                "cold_split": {"remote_s": 19.0 * scale}},
        "pool": {"runs": [{"split": {"map_to_output_s": 5.0 * scale}}]},
        "cli": {"critical_paths": [{"total_ms": 100.0 * scale}]},
    }


def test_rows_read_each_run_and_a_missing_field_is_none():
    rows = {(phase, label): (b, n) for phase, label, _unit, b, n in compare_smoke.compare(_run(1.0), _run(2.0))}
    assert rows[("worker", "cold .map() input -> output")] == (20.0, 40.0)
    assert rows[("worker", "warm .map() input -> output")] == (3.0, 6.0)
    assert rows[("app", "warm method ping, median of 5")] == (5.0, 10.0)
    assert rows[("pool", "pooled .map() input -> output")] == (5.0, 10.0)
    assert rows[("cli", "cold class call, critical path")] == (100.0, 200.0)
    assert rows[("image", "pooled: call -> result")] == (None, None)
    assert {phase for phase, _ in rows} == set(compare_smoke.PHASES)


def test_main_prints_differences_and_phase_wall_times(tmp_path, capsys):
    for name, scale, worker_s in (("base", 1.0, 132.4), ("new", 2.0, 111.3)):
        (tmp_path / f"{name}.json").write_text(json.dumps(_run(scale)))
        (tmp_path / f"{name}.log").write_text(f"noise\n[worker] phase done in {worker_s}s, 365.7 MB allocated\n"
                                              "[cli] phase done in 74.0s, 1 MB allocated\n")
    compare_smoke.main([str(tmp_path / "base.json"), str(tmp_path / "new.json")])
    out = capsys.readouterr().out.splitlines()
    row = next(line for line in out if "cold .map() input -> output" in line)
    assert row.split()[-3:] == ["20.0000", "40.0000", "20.0000"]
    wall = next(line for line in out if line.startswith("worker") and "phase wall time" in line)
    assert wall.split()[-3:] == ["132.4000", "111.3000", "-21.1000"]
    assert out[-1].split()[-3:] == ["206.4000", "185.3000", "-21.1000"]
    assert compare_smoke.phase_seconds(str(tmp_path / "absent.log")) == {}
