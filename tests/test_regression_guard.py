"""Regression-guard behavior tests (reference: bench/regression_test.cc).

The guard itself shells the bench suite; these tests drive `compare()` and
the CLI against synthetic suite data so the band logic (±10%, ±5% for
FFT-1024, downward-only for counters) is verified without touching a device.
The timer and device record every measurement carries are checked here too.
"""

import json
import os
import subprocess
import sys

import pytest

from crlot_tpu.bench.regression import band_for, compare


BASE = {
    "fft_roundtrip_n1024_b1_us": 100.0,
    "e2e_1s48k_n1024_h256_ms": 1.0,
    "e2e_1s48k_n1024_h256_rtf": 1000.0,
    "e2e_1s48k_n1024_h256_snr_db": 95.0,
}


def test_bands():
    assert band_for("fft_roundtrip_n1024_b1_us") == 0.05
    assert band_for("ola_n1024_h512_f375_us") == 0.10


def test_within_band_passes():
    cur = dict(BASE)
    cur["e2e_1s48k_n1024_h256_ms"] = 1.05  # +5% < 10% band
    ok, report = compare(cur, BASE)
    assert ok, report


def test_twenty_percent_slowdown_fails():
    cur = dict(BASE)
    cur["e2e_1s48k_n1024_h256_ms"] = 1.20
    ok, report = compare(cur, BASE)
    assert not ok
    failed = [r for r in report if r.get("pass") is False]
    assert failed and failed[0]["metric"] == "e2e_1s48k_n1024_h256_ms"


def test_fft1024_tight_band():
    cur = dict(BASE)
    cur["fft_roundtrip_n1024_b1_us"] = 107.0  # +7% > 5% band
    ok, _ = compare(cur, BASE)
    assert not ok


def test_counter_regressions_are_downward():
    cur = dict(BASE)
    cur["e2e_1s48k_n1024_h256_rtf"] = 850.0  # -15% throughput
    ok, _ = compare(cur, BASE)
    assert not ok
    cur["e2e_1s48k_n1024_h256_rtf"] = 2000.0  # faster is never a regression
    cur["e2e_1s48k_n1024_h256_snr_db"] = 95.0
    ok, _ = compare(cur, BASE)
    assert ok


def test_nan_is_skipped_not_failed():
    cur = dict(BASE)
    cur["e2e_1s48k_n1024_h256_ms"] = float("nan")  # unmeasurable
    ok, report = compare(cur, BASE)
    assert ok
    notes = [r for r in report if "note" in r]
    assert notes and "unmeasurable" in notes[0]["note"]


def test_timer_record_fields():
    """The one timer: warm-up, then median and p90 of the timed calls."""
    import jax.numpy as jnp

    from crlot_tpu.bench.device import time_call

    calls = []

    def fn(v):
        calls.append(1)
        return v + 1

    rec = time_call(fn, jnp.ones(4), iters=5, warmup=2)
    assert set(rec) == {"median_s", "p90_s", "iters"}
    assert rec["iters"] == 5 and len(calls) == 7
    assert 0.0 < rec["median_s"] <= rec["p90_s"]
    with pytest.raises(ValueError):
        time_call(fn, jnp.ones(4), iters=0)


def test_cli_verdict_on_synthetic_regression(tmp_path):
    """End-to-end CLI: a 20% slowdown against a saved baseline exits 1 and
    reports the violation (regression_test.cc:173-186 contract)."""
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps({"NVIDIA H100 80GB HBM3": BASE}))
    cur = dict(BASE, _device_kind="NVIDIA H100 80GB HBM3")
    cur["e2e_1s48k_n1024_h256_ms"] = 1.25
    current = tmp_path / "current.json"
    current.write_text(json.dumps(cur))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "-m", "crlot_tpu.bench.regression",
         "--baseline", str(baseline), "--current", str(current)],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert p.returncode == 1, p.stdout + p.stderr
    verdict = json.loads(p.stdout.strip().splitlines()[-1])
    assert verdict["pass"] is False and verdict["exit"] == 1


def test_nan_baseline_is_skipped():
    """A NaN recorded INTO the baseline must not poison
    the verdict (cur/NaN fails every band otherwise)."""
    base = dict(BASE)
    base["ola_n1024_h512_f375_us"] = float("nan")
    cur = dict(BASE)
    cur["ola_n1024_h512_f375_us"] = 123.0
    ok, report = compare(cur, base)
    assert ok
    assert not any(r["metric"] == "ola_n1024_h512_f375_us" for r in report)


HEADLINE_BASE = {
    "headline_roundtrip_ms": 0.45,
    "headline_snr_db": 130.2,
}


def test_device_record_fields():
    """Every measurement names its device as JAX reports it."""
    import jax

    from crlot_tpu.bench.device import device_record

    rec = device_record()
    assert set(rec) == {"platform", "kind", "count", "name_power_limit"}
    assert rec["platform"] == jax.devices()[0].platform
    assert rec["kind"] == jax.devices()[0].device_kind
    assert rec["count"] == len(jax.devices())


def test_require_gpu_refuses_cpu():
    from crlot_tpu.bench.device import require_gpu

    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu()


def test_unknown_device_has_no_peaks():
    """A device that is not in the peaks table is an error, never a
    default; the H100 SXM row is matched exactly, not by substring."""
    from crlot_tpu.profiling import device_specs

    with pytest.raises(KeyError):
        device_specs("cpu")
    with pytest.raises(KeyError):
        device_specs("NVIDIA H100 PCIe")
    hbm, bf16, tf32, f32 = device_specs("NVIDIA H100 80GB HBM3")
    assert (hbm, bf16, tf32, f32) == (3.35e12, 989e12, 495e12, 67e12)


def test_snr_band_is_absolute_half_db():
    cur = dict(HEADLINE_BASE)
    cur["headline_snr_db"] = 130.2 - 0.4  # inside the 0.5 dB band
    ok, _ = compare(cur, HEADLINE_BASE)
    assert ok
    cur["headline_snr_db"] = 130.2 - 0.6  # outside
    ok, report = compare(cur, HEADLINE_BASE)
    assert not ok
    # A relative 10% band would have allowed a 13 dB drop; assert the
    # absolute rule really is the one applied.
    cur["headline_snr_db"] = 130.2 * 0.92
    ok, _ = compare(cur, HEADLINE_BASE)
    assert not ok


def test_headline_merge():
    from crlot_tpu.bench.regression import merge_headline

    cur = {}
    merge_headline(cur, {
        "value": 6.5e9, "median_s": 0.00045, "p90_s": 0.0005,
        "snr_db": 130.2,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3"},
    })
    assert cur["headline_roundtrip_ms"] == pytest.approx(0.45)
    assert cur["headline_snr_db"] == 130.2
    assert cur["_device_kind"] == "NVIDIA H100 80GB HBM3"
    # A 20% slower headline fires the timing band.
    slow = dict(cur, headline_roundtrip_ms=0.45 * 1.2)
    ok, _ = compare(slow, cur)
    assert not ok


def test_armed_but_unmeasured_metric_is_reported():
    """A baseline key missing from the run must surface as a note, never a
    silent omission."""
    cur = {k: v for k, v in HEADLINE_BASE.items()
           if k != "headline_roundtrip_ms"}
    ok, report = compare(cur, HEADLINE_BASE)
    assert ok  # not a failure...
    notes = [r for r in report
             if r.get("note") == "armed but not measured this run"]
    assert notes and notes[0]["metric"] == "headline_roundtrip_ms"  # ...but visible
