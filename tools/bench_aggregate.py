"""Merge N bench captures into per-key median/min/max with spread.

Best-of-N reporting without N or spread hides exactly the variance a
reader needs, so quote medians with N and spread: every completed
``bench.py`` run appends its capture to ``bench_runs/run_<epoch>.json``
(a directory the checkout does not track); aggregate them here.

Degraded-capture handling: a value whose sibling ``<key>_degraded`` flag
is true in the SAME run (the dual-slope consistency check failed) is
excluded from the statistics and counted in ``degraded_n`` instead, so
one bad capture cannot poison the median while still being visible.

Usage::

    python tools/bench_aggregate.py                 # bench_runs/*.json, JSON out
    python tools/bench_aggregate.py --markdown      # README-ready table
    python tools/bench_aggregate.py a.json b.json   # explicit captures
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

# keys that are run metadata, not measurements
_META_KEYS = {"vs_baseline", "elapsed_s"}
_META_SUFFIXES = ("_degraded", "_spread", "_slopes", "_slopes_us")


def _is_measurement(key: str, value) -> bool:
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return False
    if key in _META_KEYS:
        return False
    return not key.endswith(_META_SUFFIXES)


def aggregate(runs: list[dict]) -> dict:
    """Per-key stats across runs: {key: {n, median, min, max, spread_pct,
    degraded_n}} with degraded captures excluded from the stats."""
    keys: dict[str, dict] = {}
    for run in runs:
        for key, value in run.items():
            if not _is_measurement(key, value):
                continue
            entry = keys.setdefault(key, {"values": [], "degraded_n": 0})
            if run.get(f"{key}_degraded"):
                entry["degraded_n"] += 1
            else:
                entry["values"].append(float(value))
    out = {}
    for key, entry in sorted(keys.items()):
        vals = sorted(entry["values"])
        stats = {"n": len(vals), "degraded_n": entry["degraded_n"]}
        if vals:
            mid = len(vals) // 2
            median = (
                vals[mid]
                if len(vals) % 2
                else 0.5 * (vals[mid - 1] + vals[mid])
            )
            stats.update(
                median=round(median, 4),
                min=round(vals[0], 4),
                max=round(vals[-1], 4),
                # full spread as a fraction of the median: the honest
                # run-to-run variance statement for the README
                spread_pct=(
                    round(100.0 * (vals[-1] - vals[0]) / median, 1)
                    if median
                    else 0.0
                ),
            )
        out[key] = stats
    return out


def to_markdown(agg: dict) -> str:
    lines = [
        "| key | n | median | min | max | spread | degraded |",
        "|---|---|---|---|---|---|---|",
    ]
    for key, s in agg.items():
        if s["n"] == 0:
            lines.append(f"| {key} | 0 | — | — | — | — | {s['degraded_n']} |")
            continue
        lines.append(
            f"| {key} | {s['n']} | {s['median']:,} | {s['min']:,} | "
            f"{s['max']:,} | ±{s['spread_pct'] / 2:.0f}% | {s['degraded_n']} |"
        )
    return "\n".join(lines)


def load_runs(paths: list[Path]) -> list[dict]:
    runs = []
    for p in paths:
        try:
            runs.append(json.loads(p.read_text()))
        except (OSError, json.JSONDecodeError) as e:
            print(f"skipping {p}: {e}", file=sys.stderr)
    return runs


def main(argv: list[str]) -> int:
    markdown = "--markdown" in argv
    files = [Path(a) for a in argv if not a.startswith("--")]
    if not files:
        runs_dir = Path(__file__).resolve().parents[1] / "bench_runs"
        files = sorted(runs_dir.glob("run_*.json"))
    if not files:
        print("no captures found (bench_runs/run_*.json)", file=sys.stderr)
        return 1
    agg = aggregate(load_runs(files))
    if markdown:
        print(f"Aggregated over {len(files)} runs:\n")
        print(to_markdown(agg))
    else:
        print(json.dumps({"runs": len(files), "keys": agg}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
