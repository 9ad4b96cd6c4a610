"""The port's benchmark twins (``repro_torch.benchmarks``) on the CPU at a
tiny size: each runs and writes its keys, and the autoscaler twin's
``SimPipeline`` verdicts equal the reference's ``run_autoscale``
(``benchmarks/table2_e2e.py``, loaded by file path) on one injected
calibration."""
import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.benchmarks import table2_autoscale, table4_obs

ROOT = Path(__file__).resolve().parents[1]
CALIBRATIONS = [
    ({0: 3.2e-3, 1: 3.6e-4, 2: 3.7e-4, 3: 3.5e-4}, 4.8e-4, True),   # the slow shard 9x: the loop acts
    ({0: 1.1e-3, 1: 1.4e-4, 2: 1.3e-4, 3: 1.5e-4}, 2.9e-3, False),  # compute-bound: one reader is enough
]


def _reference():
    spec = importlib.util.spec_from_file_location("reference_table2_e2e", ROOT / "benchmarks" / "table2_e2e.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cal", CALIBRATIONS)
def test_simulated_modes_equal_the_reference(tmp_path, monkeypatch, cal):
    part_service, consume_s, acts = cal
    ref = _reference()
    monkeypatch.setattr(ref, "_write_slow_shard_table", lambda table: table)
    monkeypatch.setattr(ref, "_calibrate_reads", lambda table: dict(part_service))
    monkeypatch.setattr(ref, "_calibrate_compute", lambda: consume_s)
    want = ref.run_autoscale(steps=400, out_dir=tmp_path)
    got = table2_autoscale.simulate_modes(part_service, consume_s, 400)
    for mode in ("fixed", "autoscale"):
        assert {k: got[mode][k] for k in want[mode]["sim"]} == want[mode]["sim"], mode
    assert got["fixed"]["n_actions"] == 0
    assert (got["autoscale"]["n_actions"] > 0) == acts


def test_table2_twin_runs_and_writes_its_keys(tmp_path):
    out = tmp_path / "t2.json"
    res = table2_autoscale.main(["--device", "cpu", "--steps", "60", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert sorted(res["calibration"]["part_service_ms"]) == ["0", "1", "2", "3"]
    assert res["calibration"]["compute_ms"] > 0
    for mode in ("fixed", "autoscale"):
        assert {"data_wait_total_s", "virtual_steps_per_s", "n_readers_final", "n_actions"} <= set(res[mode])
    assert res["fixed"]["n_readers_final"] == 1


def test_table4_twin_runs_and_writes_its_keys(tmp_path):
    out = tmp_path / "t4.json"
    res = table4_obs.run(steps=3, repeats=2, device="cpu", out=out, micro_n=1000)
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert [len(v) for v in res["runs_steps_per_s"].values()] == [2, 2]
    assert res["base_steps_per_s"] == max(res["runs_steps_per_s"]["off"]) > 0
    assert res["telemetry_steps_per_s"] == max(res["runs_steps_per_s"]["on"]) > 0
    assert 0.0 <= res["overhead_fraction"] < 1.0
    assert res["jsonl_records"] == 3 * (3 + 1)  # the warm and the timed runs' steps and summaries
    assert set(res["micro"]) == {"counter_inc_ns", "histogram_observe_ns", "span_ns", "jsonl_emit_ns",
                                 "snapshot_merge3_us"}
