"""Survivability and device-honesty tests for bench.py's isolated runner.

The contract under test:

* after every config child process the runner prints ONE cumulative JSON
  line (each a superset of the previous) — the tail is always the most
  complete parseable record;
* a wall-clock budget skips (and names) remaining configs instead of
  overrunning;
* timed-out configs are named and do not kill the run;
* scan-slope measurements carry degraded-capture metadata;
* one probe decides whether a GPU is present; without one the run fails
  instead of measuring the CPU, and every record carries the device stamp.
"""

import json
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import bench  # noqa: E402


def test_cumulative_record_defaults():
    rec = bench._cumulative_record({}, {})
    assert rec["metric"] == "spectrum_frames_per_sec_per_chip_4096pt_stereo"
    assert rec["value"] == 0.0 and rec["unit"] == "frames/s"
    rec = bench._cumulative_record({"value": 123.0, "extra": 1}, {"elapsed_s": 2})
    assert rec["value"] == 123.0 and rec["extra"] == 1 and rec["elapsed_s"] == 2


def _fake_run_factory(results: dict, timeouts=()):
    """subprocess.run stub: returns each config's canned JSON line, or
    raises TimeoutExpired for configs named in ``timeouts``."""

    def fake_run(argv, capture_output, text, timeout):
        cfg = argv[argv.index("--only") + 1]
        if cfg in timeouts:
            raise subprocess.TimeoutExpired(argv, timeout)
        out = json.dumps(results.get(cfg, {}))
        return types.SimpleNamespace(stdout=out + "\n", stderr="", returncode=0)

    return fake_run


def test_isolated_runner_emits_cumulative_superset(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "PARTIAL_PATH", tmp_path / "partial.json")
    monkeypatch.setattr(bench, "RUNS_DIR", tmp_path / "bench_runs")
    monkeypatch.setenv("SZ_BENCH_BUDGET_S", "1e9")
    results = {
        "headline": {"value": 123.0, "metric": "m", "unit": "frames/s",
                     "vs_baseline": 0.123},
        "latency": {"p50_latency_ms": 1.5},
        "cfg1": {"cfg1_mono1024_frames_per_sec": 9.0},
    }
    monkeypatch.setattr(
        bench.subprocess, "run", _fake_run_factory(results, timeouts=("device",))
    )
    bench._run_isolated(time.monotonic())
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    # one line per config (timed-out ones included)
    assert len(lines) == len(bench.CONFIG_NAMES)
    records = [json.loads(l) for l in lines]
    # every line is parseable and carries the headline fields
    for r in records:
        assert "value" in r and "metric" in r
    # supersets: keys only accumulate
    for a, b in zip(records, records[1:]):
        assert set(a) - {"skipped_configs", "timed_out_configs", "elapsed_s"} <= set(b)
    last = records[-1]
    assert last["value"] == 123.0
    assert last["p50_latency_ms"] == 1.5
    assert last["cfg1_mono1024_frames_per_sec"] == 9.0
    assert last["timed_out_configs"] == ["device"]
    assert "skipped_configs" not in last
    # the partial file mirrors the cumulative parts for the aggregator
    saved = json.loads((tmp_path / "partial.json").read_text())
    assert saved["value"] == 123.0


def test_isolated_runner_budget_skips_and_names_remaining(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "PARTIAL_PATH", tmp_path / "partial.json")
    monkeypatch.setattr(bench, "RUNS_DIR", tmp_path / "bench_runs")
    # budget covers the headline config only: fake clock advances 100 s
    # per subprocess call against a 140 s budget
    monkeypatch.setenv("SZ_BENCH_BUDGET_S", "140")
    clock = {"t": 0.0}
    monkeypatch.setattr(bench.time, "monotonic", lambda: clock["t"])

    def fake_run(argv, capture_output, text, timeout):
        clock["t"] += 100.0
        cfg = argv[argv.index("--only") + 1]
        payload = (
            {"value": 5.0, "metric": "m", "unit": "frames/s", "vs_baseline": 0.005}
            if cfg == "headline"
            else {cfg + "_key": 1}
        )
        return types.SimpleNamespace(
            stdout=json.dumps(payload) + "\n", stderr="", returncode=0
        )

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    bench._run_isolated(t_start=0.0)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1  # headline ran, then the budget gate closed
    last = json.loads(lines[-1])
    assert last["value"] == 5.0
    assert last["skipped_configs"] == list(bench.CONFIG_NAMES[1:])


def test_isolated_runner_headline_failure_raises(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "PARTIAL_PATH", tmp_path / "partial.json")
    monkeypatch.setattr(bench, "RUNS_DIR", tmp_path / "bench_runs")
    monkeypatch.setenv("SZ_BENCH_BUDGET_S", "1e9")
    monkeypatch.setattr(bench.subprocess, "run", _fake_run_factory({}))
    with pytest.raises(RuntimeError):
        bench._run_isolated(time.monotonic())
    # even then, every emitted line parsed
    for l in capsys.readouterr().out.splitlines():
        json.loads(l)


def test_scan_rate_returns_meta():
    import jax.numpy as jnp

    rate, meta = bench._scan_rate(lambda c: c + 1.0, jnp.float32(0.0), k1=2, k2=8, reps=2)
    assert rate > 0
    assert "degraded" in meta and "spread" in meta
    out = {}
    bench._scan_key(out, "k", 4.0, lambda c: c + 1.0, jnp.float32(0.0), k1=2, k2=8, reps=2)
    assert out["k"] > 0
    if out.get("k_degraded"):
        assert "k_spread" in out


def test_aggregate_medians_and_degraded_exclusion():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import bench_aggregate as agg

    runs = [
        {"value": 100.0, "cfg2_x": 10.0, "on_device_step_us": 40.0},
        {"value": 300.0, "cfg2_x": 30.0, "on_device_step_us": 1000.0,
         "on_device_step_us_degraded": True},
        {"value": 200.0, "cfg2_x": 20.0, "remap_mode": "gather",
         "some_flag": True, "elapsed_s": 99.0},
    ]
    out = agg.aggregate(runs)
    assert out["value"] == {
        "n": 3, "degraded_n": 0, "median": 200.0, "min": 100.0,
        "max": 300.0, "spread_pct": 100.0,
    }
    # degraded capture excluded from stats but counted
    assert out["on_device_step_us"]["n"] == 1
    assert out["on_device_step_us"]["median"] == 40.0
    assert out["on_device_step_us"]["degraded_n"] == 1
    # strings, bools, and metadata keys are not measurements
    assert "remap_mode" not in out and "some_flag" not in out
    assert "elapsed_s" not in out and "on_device_step_us_degraded" not in out
    md = agg.to_markdown(out)
    assert "| value | 3 | 200.0 |" in md


def test_save_run_appends_capture(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "RUNS_DIR", tmp_path / "bench_runs")
    bench._save_run({"value": 7.0})
    files = list((tmp_path / "bench_runs").glob("run_*.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text()) == {"value": 7.0}
    bench._save_run({})  # empty capture is not persisted
    assert len(list((tmp_path / "bench_runs").glob("run_*.json"))) == 1


def test_save_run_records_coverage(monkeypatch, tmp_path):
    # a budget-truncated run names the configs it never reached, so the
    # aggregator's reader can tell "not measured" from "measured zero";
    # empty coverage lists are dropped, and the aggregator must ignore
    # the list-valued metadata when computing stats
    monkeypatch.setattr(bench, "RUNS_DIR", tmp_path / "bench_runs")
    bench._save_run(
        {"value": 7.0},
        {"skipped_configs": ["cfg6"], "timed_out_configs": []},
    )
    (saved,) = (tmp_path / "bench_runs").glob("run_*.json")
    record = json.loads(saved.read_text())
    assert record == {"value": 7.0, "skipped_configs": ["cfg6"]}
    import bench_aggregate as agg

    out = agg.aggregate([record])
    assert list(out) == ["value"]


GPU_STAMP = {
    "platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
    "device_count": 1, "gpu_name": "NVIDIA H100 80GB HBM3",
    "power_limit": "700.00 W",
}


def _fake_probe(stdout="", returncode=0, stderr=""):
    def fake_run(argv, capture_output, text, timeout):
        assert "-c" in argv  # one child process, never jax in the parent
        return types.SimpleNamespace(stdout=stdout, stderr=stderr, returncode=returncode)

    return fake_run


def test_probe_returns_gpu_stamp(monkeypatch):
    monkeypatch.setattr(bench.subprocess, "run", _fake_probe(json.dumps(GPU_STAMP) + "\n"))
    assert bench._probe_device() == GPU_STAMP


@pytest.mark.parametrize(
    "stdout,returncode",
    [
        (json.dumps(dict(GPU_STAMP, platform="cpu")) + "\n", 0),  # no card
        ("", 1),  # the child died (e.g. backend init failed)
        ("", 0),  # the child printed nothing
    ],
)
def test_probe_refuses_without_gpu(monkeypatch, stdout, returncode):
    calls = []

    def fake_run(argv, capture_output, text, timeout):
        calls.append(argv)
        return types.SimpleNamespace(stdout=stdout, stderr="boom", returncode=returncode)

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError):
        bench._probe_device()
    assert len(calls) == 1  # a single check: no retries


def test_records_carry_device_stamp(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "PARTIAL_PATH", tmp_path / "partial.json")
    monkeypatch.setattr(bench, "RUNS_DIR", tmp_path / "bench_runs")
    monkeypatch.setenv("SZ_BENCH_BUDGET_S", "1e9")
    results = {"headline": {"value": 1.0, "metric": "m", "unit": "frames/s",
                            "vs_baseline": 0.001}}
    monkeypatch.setattr(bench.subprocess, "run", _fake_run_factory(results))
    bench._run_isolated(time.monotonic(), GPU_STAMP)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert lines
    for rec in lines:
        for key, value in GPU_STAMP.items():
            assert rec[key] == value


def test_device_peaks_keyed_by_kind():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12 and peaks["f32_flops"] == 67e12
    # an unknown card is an error, never a silent H100 default
    with pytest.raises(KeyError):
        bench.device_peaks("Some Other Accelerator")
    with pytest.raises(KeyError):
        bench.device_peaks("cpu")


@pytest.mark.parametrize("limit_w,below", [(700.0, False), (400.0, True), (None, True)])
def test_peak_shares_flagged_below_rated_power(limit_w, below):
    note = bench.peak_share_note(bench.device_peaks("NVIDIA H100 80GB HBM3"), limit_w)
    assert note == {"power_limit_w": limit_w, "peaks_rated_at_w": 700.0,
                    "shares_below_rated_power": below}


def test_bench_without_gpu_exits_nonzero(tmp_path):
    """On the CPU the whole run fails after the one probe: exit code 1 and
    an error record with no measured value — no CPU fallback."""
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu", SZ_BENCH_BUDGET_S="600")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, str(root / "bench.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode != 0
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["value"] == 0.0 and "no GPU" in last["error"]
