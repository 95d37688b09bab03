"""Performance-regression guard with saved baselines and tolerance bands.

Reference: bench/regression_test.cc — runs the benchmark suites, parses the
timings, compares against a saved `name: time` baseline within a ±10% band
(±5% for FFT-1024), and `--update-baseline` writes a new one. Same contract
here over a JSON record of `name: value` metrics, keyed in the baseline
file by the device kind that measured it.

Run: python -m crlot_tpu.bench.regression --current RUN.json
         [--headline BENCH.json] [--baseline PATH] [--update-baseline]
Exit code 0 = within bands, 1 = regression detected.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Dict, Tuple

DEFAULT_BAND = 0.10  # ±10% (regression_test.cc:20)
FFT1024_BAND = 0.05  # ±5% for the FFT-1024 metric (regression_test.cc:173-175)
SNR_ABS_BAND_DB = 0.5  # SNR compares in ABSOLUTE dB (a ratio band on a log
# quantity would allow a 9.5 dB drop from 95 dB — meaningless)

_BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")
_KEY = "_device_kind"


def band_for(name: str) -> float:
    return FFT1024_BAND if "fft" in name and "n1024" in name else DEFAULT_BAND


def is_timing_metric(name: str) -> bool:
    """Only latency-like metrics regress upward; counters (rtf, snr, pct)
    are checked downward."""
    return name.endswith(("_us", "_ms", "_ns_per_elem"))


def is_pct_metric(name: str) -> bool:
    """Percentage metrics (roofline shares and the like) regress downward."""
    return name.endswith("_pct") or "_pct_" in name


def compare(
    current: Dict[str, float], baseline: Dict[str, float]
) -> Tuple[bool, list]:
    report = []
    ok = True
    for name, base in baseline.items():
        if name.startswith("_"):
            continue
        if name not in current:
            # An armed band that was never measured this run must be
            # VISIBLE, not a silent pass. A note, not a failure:
            # unmeasured is not a regression verdict.
            report.append(
                {"metric": name, "baseline": base, "pass": None,
                 "note": "armed but not measured this run"}
            )
            continue
        cur = current[name]
        # A NaN baseline must not poison the verdict: NaN <= 0 is False,
        # and cur/NaN would fail every band.
        if (not isinstance(base, (int, float)) or not math.isfinite(base)
                or base <= 0):
            continue
        if not isinstance(cur, (int, float)) or not math.isfinite(cur):
            # An unmeasurable metric is not a regression verdict.
            report.append(
                {"metric": name, "baseline": base, "current": cur,
                 "pass": None, "note": "unmeasurable (NaN) — skipped"}
            )
            continue
        band = band_for(name)
        ratio = cur / base
        if is_timing_metric(name):
            passed = ratio <= 1.0 + band
        elif name.endswith("_snr_db"):
            passed = cur >= base - SNR_ABS_BAND_DB
            band = f"-{SNR_ABS_BAND_DB} dB abs"
        elif name.endswith("_rtf") or is_pct_metric(name):
            passed = ratio >= 1.0 - band
        else:
            continue
        ok &= passed
        report.append(
            {
                "metric": name,
                "baseline": base,
                "current": cur,
                "ratio": round(ratio, 3),
                "band": band,
                "pass": passed,
            }
        )
    return ok, report


def merge_headline(current: Dict[str, float], headline: dict) -> None:
    """Fold the headline bench record (bench.py's JSON line) into a run's
    metrics under `headline_*` names: its median time (banded upward) and
    its SNR (banded in absolute dB)."""
    if "median_s" in headline:
        current["headline_roundtrip_ms"] = headline["median_s"] * 1e3
    if "snr_db" in headline:
        current["headline_snr_db"] = headline["snr_db"]
    kind = (headline.get("device") or {}).get("kind")
    if kind:
        current.setdefault(_KEY, kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--update-baseline", action="store_true")
    ap.add_argument("--baseline", default=_BASELINE_PATH)
    ap.add_argument("--current", required=True,
                    help="JSON record of this run's metrics")
    ap.add_argument("--headline", default=None,
                    help="bench.py JSON record to merge under headline_*")
    args = ap.parse_args(argv)

    with open(args.current) as f:
        current = json.loads(f.read().strip())
    if args.headline:
        with open(args.headline) as f:
            merge_headline(current, json.loads(f.read().strip()))

    key = current.get(_KEY, "unknown")
    baselines = {}
    if os.path.exists(args.baseline):
        with open(args.baseline) as f:
            baselines = json.load(f)

    if args.update_baseline:
        baselines[key] = current
        with open(args.baseline, "w") as f:
            json.dump(baselines, f, indent=1, sort_keys=True)
        print(json.dumps({"updated": args.baseline, "device_kind": key}))
        return 0

    if key not in baselines:
        print(json.dumps({"error": f"no baseline for device kind '{key}'",
                          "hint": "run with --update-baseline first"}))
        return 0  # no baseline yet is not a failure

    ok, report = compare(current, baselines[key])
    print(json.dumps({"pass": ok, "exit": 0 if ok else 1,
                      "device_kind": key, "checks": report}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
