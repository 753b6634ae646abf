"""Summarize a trace + metrics pair from an instrumented run.

  PYTHONPATH=src python -m repro_torch.obs.report --trace train.trace.json \
      --metrics train.metrics.jsonl

Reads the Chrome-trace-event JSON written by ``--trace`` and the JSONL
written by ``--metrics`` (``repro_torch.launch.train`` and
``repro_torch.launch.serve``) and prints:

* **top spans** — total/mean duration and count per span name, per lane,
  from the ph:"X" events (where the step time actually goes);
* **step-time breakdown** — mean per-phase seconds and the pipeline bubble
  fraction over the run's "step" records (pipelined runs only; the bubble is
  the fraction of each step's wall time the dispatcher spent blocked on the
  scheduler — 0 means perfect overlap);
* **cache hit tables** — every ``*_hits``/``*_misses`` pair in the final
  registry snapshot record, one row per cache instance.

All three sections degrade gracefully: pass only one of --trace/--metrics
and the other sections are skipped.
"""
from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.obs.sink import read_jsonl
from repro_torch.obs.trace import validate_trace

__all__ = ["summarize_trace", "summarize_metrics", "cache_tables", "main"]


def summarize_trace(obj, top: int = 8) -> str:
    """Top spans by total duration, grouped per lane."""
    summary = validate_trace(obj)
    lanes: Dict[int, str] = {}
    for ev in obj["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            lanes[ev["tid"]] = ev["args"]["name"]
    agg: Dict[str, Dict[str, List[float]]] = defaultdict(lambda: defaultdict(list))
    for ev in obj["traceEvents"]:
        if ev.get("ph") == "X":
            lane = lanes.get(ev["tid"], f"tid {ev['tid']}")
            agg[lane][ev["name"]].append(ev["dur"])
    lines = [f"trace: {summary['n_events']} events, "
             f"{len(summary['lanes'])} lanes "
             f"({', '.join(summary['lanes'])})"]
    for lane in sorted(agg):
        lines.append(f"  lane [{lane}]")
        rows = sorted(agg[lane].items(),
                      key=lambda kv: -sum(kv[1]))[:top]
        for name, durs in rows:
            tot = sum(durs)
            lines.append(f"    {name:<14} {len(durs):>6}x  "
                         f"total {tot/1e3:>9.1f} ms  "
                         f"mean {tot/len(durs)/1e3:>7.3f} ms")
    return "\n".join(lines)


def summarize_metrics(records: List[dict]) -> str:
    """Mean phase seconds + bubble fraction over the run's step records."""
    steps = [r for r in records if r.get("kind") == "step"]
    if not steps:
        return "metrics: no step records (snapshot-only file)"
    phase_keys = sorted({k for r in steps for k in r
                         if k.endswith("_s") and k != "wall_s"})
    lines = [f"metrics: {len(steps)} step records "
             f"(mode {steps[0].get('mode', '?')})"]
    wall = sum(r.get("wall_s", 0.0) for r in steps)
    for k in phase_keys:
        tot = sum(r.get(k, 0.0) for r in steps)
        share = f"  ({tot / wall:.1%} of wall)" if wall else ""
        lines.append(f"  {k[:-2]:<14} total {tot:>8.3f} s  "
                     f"mean {tot / len(steps) * 1e3:>8.2f} ms/step{share}")
    bubbles = [r["bubble_frac"] for r in steps if "bubble_frac" in r]
    if bubbles:
        lines.append(f"  pipeline bubble: mean {sum(bubbles)/len(bubbles):.1%}"
                     f", max {max(bubbles):.1%} "
                     f"(overlap {1 - sum(bubbles)/len(bubbles):.1%})")
    return "\n".join(lines)


_HIT_RE = re.compile(r"^(?P<base>[a-z0-9_]+)_hits(?P<labels>\{.*\})?$")


def cache_tables(snapshot: Dict[str, float]) -> str:
    """One row per ``*_hits``/``*_misses`` pair in a registry snapshot."""
    rows = []
    for key, hits in sorted(snapshot.items()):
        m = _HIT_RE.match(key)
        if not m:
            continue
        miss_key = f"{m['base']}_misses{m['labels'] or ''}"
        misses = snapshot.get(miss_key)
        if misses is None:
            continue
        total = hits + misses
        rate = hits / total if total else 0.0
        label = f"{m['base']}{m['labels'] or ''}"
        rows.append(f"  {label:<40} hits {int(hits):>8}  "
                    f"misses {int(misses):>7}  rate {rate:>6.1%}")
    if not rows:
        return "caches: no hit/miss pairs in snapshot"
    return "\n".join(["caches:"] + rows)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.report")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace-event JSON written by --trace")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="JSONL written by --metrics")
    ap.add_argument("--top", type=int, default=8,
                    help="span names per lane in the trace table")
    args = ap.parse_args(argv)
    if not args.trace and not args.metrics:
        ap.error("pass --trace and/or --metrics")
    if args.trace:
        with open(args.trace) as f:
            print(summarize_trace(json.load(f), top=args.top))
    if args.metrics:
        records = read_jsonl(args.metrics)
        print(summarize_metrics(records))
        snaps = [r for r in records if r.get("kind") == "snapshot"]
        if snaps:
            print(cache_tables(snaps[-1]["metrics"]))


if __name__ == "__main__":
    main()
