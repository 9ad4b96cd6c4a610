"""The port's Prometheus exposition, telemetry aggregator and MBU bridge
(``repro_torch.obs``) against the JAX package's (``repro.obs``) on the CPU:
byte-equal exposition text from registries built by the same operations,
the same validator verdicts and mangling errors, a live scrape, equal
``agg/*`` values over the same worker traces, and equal MBU gauges."""
import contextlib
import io
import random
import types
import urllib.request

import pytest

from repro import obs as j_obs
from repro.obs import aggregator as j_agg, prometheus as j_prom
from repro_torch import obs as t_obs
from repro_torch.obs import aggregator as t_agg, prometheus as t_prom


def _registry(obs, seed: int, slow: float = 1.0):
    """The same operations on either package's registry."""
    reg = obs.MetricsRegistry()
    r = random.Random(seed)
    reg.counter("trainer/steps").inc(100)
    reg.counter("io/rows_total").inc(3200 + seed)
    reg.counter("storage/hits", shard=3).inc(7)
    reg.gauge("io/queue_depth").set(float(seed + 1))
    reg.gauge("io/queue_capacity").set(8.0)
    reg.gauge("autoscale/readers").set(2)
    dev = reg.histogram("trace/device_step_s")
    wait = reg.histogram("trace/data_wait_s")
    for _ in range(100):
        dev.observe(slow * (4e-3 + r.random() * 2e-4))
        wait.observe(1e-3 + r.random() * 1e-4)
    wait.observe(0.0)  # the underflow bucket renders le="0.0"
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_byte_equal_and_valid(seed):
    want = j_prom.render(_registry(j_obs, seed))
    got = t_prom.render(_registry(t_obs, seed))
    assert got == want
    assert t_prom.validate_exposition(got) == [] == j_prom.validate_exposition(want)
    assert "recis_autoscale_readers 2.0" in got


@pytest.mark.parametrize("text", [
    "recis_orphan_total 1\n",                    # a sample with no TYPE
    "# TYPE recis_x gauge\nrecis_x{oops 1\n",     # a broken label set
    "# TYPE recis_x gauge\n# TYPE recis_x gauge\nrecis_x 1\n",
])
def test_validator_verdicts_equal(text):
    assert t_prom.validate_exposition(text) == j_prom.validate_exposition(text) != []


def test_validator_catches_a_count_mismatch_in_both():
    good = t_prom.render(_registry(t_obs, 0))
    bad = good.replace('le="+Inf"} 101', 'le="+Inf"} 99')
    assert bad != good
    assert t_prom.validate_exposition(bad) == j_prom.validate_exposition(bad) != []


def test_mangling_collision_raises_in_both():
    for prom, obs in ((j_prom, j_obs), (t_prom, t_obs)):
        assert prom.mangle("agg/skew/data_wait") == "recis_agg_skew_data_wait"
        with pytest.raises(ValueError, match="collision"):
            prom.mangling_table(["a/b_c", "a/b/c"])
        reg = obs.MetricsRegistry()
        reg.counter("a/b_c").inc()
        reg.counter("a/b/c").inc()
        with pytest.raises(ValueError, match="collision"):
            prom.render(reg)


def test_live_scrape():
    reg = _registry(t_obs, 1)
    exp = t_obs.PrometheusExporter(reg, port=0)
    port = exp.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
            assert r.status == 200
        assert body == t_prom.render(reg)
        assert t_obs.validate_exposition(body) == []
    finally:
        exp.stop()
    assert exp.port is None


@pytest.fixture()
def three_worker_traces(tmp_path):
    """Three workers' telemetry files, written once by the reference's
    writer; w2's device_step is 4x slower, w1 restarted once (two epochs)."""
    paths = []
    for i in range(3):
        p = tmp_path / f"w{i}.jsonl"
        with j_obs.TelemetryWriter(p) as w:
            w.emit({"type": "step", "step": 1, "spans": {}})  # noise
            for epoch in ((0, 50) if i == 1 else (0,)):
                reg = _registry(j_obs, i + epoch, slow=4.0 if i == 2 else 1.0)
                snap = j_obs.RegistrySnapshot.capture(reg, worker=f"w{i}", t=float(100 + i), epoch=epoch)
                w.emit({"type": "snapshot", "step": 100, "worker": f"w{i}", "snapshot": snap.to_json()})
        paths.append(p)
    return paths


def test_aggregator_agg_values_equal(three_worker_traces):
    out = {}
    for name, obs in (("j", j_obs), ("t", t_obs)):
        agg = obs.TelemetryAggregator(three_worker_traces, skew_threshold=1.5)
        n = agg.poll()
        reg = agg.publish()
        out[name] = dict(n=n, workers=agg.workers, skew=agg.skew(), stragglers=agg.attribute(),
                         queue=agg.agg_queue(), snapshot=reg.snapshot(), text=obs.render(reg))
    assert out["t"] == out["j"]
    assert out["t"]["n"] == 4 and out["t"]["stragglers"][0]["worker"] == "w2"
    assert t_obs.validate_exposition(out["t"]["text"]) == []


def test_aggregator_cli_prints_the_same_report(three_worker_traces):
    paths = [str(p) for p in three_worker_traces]
    printed = {}
    for name, agg in (("j", j_agg), ("t", t_agg)):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert agg._main(paths) == 0
        printed[name] = buf.getvalue()
    assert printed["t"] == printed["j"] and '"w2"' in printed["t"]


def test_record_mbu_and_roofline_write_equal_gauges():
    result = types.SimpleNamespace(name="fused gather/dim128", mbu=0.91, achieved_bw=3.05e12,
                                   essential_bytes=2.1e8, wall_s=6.9e-5, bandwidth_intensity=0.97,
                                   moved_bytes=2.2e8)
    partial = types.SimpleNamespace(**{**vars(result), "bandwidth_intensity": None, "moved_bytes": None})
    terms = {"hbm_bytes": 1.5e9, "flops": 3e12, "bound": "memory", "fits": True, "t_ms": 4}
    snaps = {}
    for name, obs in (("j", j_obs), ("t", t_obs)):
        reg = obs.MetricsRegistry()
        wrote = [obs.record_mbu(result, reg), obs.record_mbu(partial, reg, prefix="mbu2"),
                 obs.record_roofline("dlrm-mlperf", "train_batch", "single", terms, reg)]
        snaps[name] = (wrote, reg.snapshot())
    assert snaps["t"] == snaps["j"]
    assert "roofline/dlrm_mlperf/train_batch/single/bound" not in snaps["t"][1]
