"""Dry-run and roofline tables from the per-cell JSON records that
``launch/dryrun.py --out DIR`` writes, as the JAX package's
``launch/report.py`` assembles them.

  python -m repro_torch.launch.report DIR

Every time in these tables is reckoned from an H100 SXM's published peaks at
700 W (``launch/roofline.py``), not measured; ``trace`` is the host seconds
of the dry run itself.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List

from repro_torch.launch.roofline import CONSTANTS, HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS

ARCH_ORDER = [
    "jamba-v0.1-52b", "qwen2-72b", "qwen3-4b", "qwen2-0.5b", "internlm2-20b",
    "whisper-large-v3", "llava-next-34b", "grok-1-314b", "mixtral-8x22b",
    "mamba2-1.3b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(results_dir: str) -> Dict[str, Dict]:
    out = {}
    for f in glob.glob(os.path.join(results_dir, "*.json")):
        tag = os.path.basename(f)[: -len(".json")]
        try:
            with open(f) as fh:
                out[tag] = json.load(fh)
        except Exception:
            out[tag] = {"error": "unparseable"}
    return out


def _fmt_b(x) -> str:
    if x is None:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if abs(x) >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def _fmt_t(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def header() -> str:
    return (f"Reckoned, not measured: {CONSTANTS} (bf16 {PEAK_FLOPS / 1e12:.0f} TFLOP/s, "
            f"HBM {HBM_BW / 1e12:.2f} TB/s, NVLink {NVLINK_BW / 1e9:.0f} GB/s, "
            f"InfiniBand {IB_BW / 1e9:.0f} GB/s a card).")


def dryrun_table(recs: Dict[str, Dict], suffix: str) -> List[str]:
    lines = ["| arch | shape | status | trace | peak bytes/dev | collectives (whole program) |",
             "|---|---|---|---|---|---|"]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get(f"{arch}_{shape}_{suffix}")
            if r is None:
                lines.append(f"| {arch} | {shape} | MISSING | | | |")
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | skip (full-attn @524k) | | | |")
                continue
            if "error" in r:
                lines.append(f"| {arch} | {shape} | ERROR | | | |")
                continue
            cnt = r.get("collectives_raw", {}).get("counts", {})
            cstr = " ".join(f"{k.split('-')[-1][:4]}:{v}" for k, v in sorted(cnt.items()))
            lines.append(
                f"| {arch} | {shape} | ok | {r.get('trace_s')}s "
                f"| {_fmt_b(r.get('memory', {}).get('peak_bytes'))} | {cstr} |")
    return lines


def roofline_table(recs: Dict[str, Dict]) -> List[str]:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPS/dev | useful ratio | what would move the bottleneck |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            r = recs.get(f"{arch}_{shape}_sp_exact") or recs.get(f"{arch}_{shape}_sp")
            if not r or "skipped" in r or "error" in r:
                continue
            rf = r.get("roofline", {})
            exact = "cost_exact" in r and "error" not in r.get("cost_exact", {})
            hint = _bottleneck_hint(r)
            lines.append(
                f"| {arch} | {shape} | {_fmt_t(rf.get('compute_s'))} | "
                f"{_fmt_t(rf.get('memory_s'))} | {_fmt_t(rf.get('collective_s'))} | "
                f"**{rf.get('dominant')}**{'' if exact else ' (raw)'} | "
                f"{r.get('model_flops_per_device', 0):.2e} | "
                f"{r.get('useful_flops_ratio', 0):.2f} | {hint} |")
    return lines


def _bottleneck_hint(r: Dict) -> str:
    dom = r.get("roofline", {}).get("dominant")
    kind = r.get("kind")
    by = (r.get("cost_exact") or {}).get("collective_by_type") \
        or r.get("collectives_raw", {}).get("by_type", {})
    if dom == "collective":
        worst = max(by, key=by.get) if by else "?"
        return f"cut {worst} traffic (resharding/overlap)"
    if dom == "memory":
        if kind == "decode":
            return "decode is cache-bandwidth bound: shrink/quantize KV"
        return "reduce activation traffic: fuse, reshard residual stream"
    return "near compute roofline: increase arithmetic intensity"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    results_dir = argv[0] if argv else "results/dryrun"
    recs = load(results_dir)
    print(header() + "\n")
    print("## Dry-run, single pod 16x16 (data,model)\n")
    print("\n".join(dryrun_table(recs, "sp")))
    print("\n## Dry-run, multi-pod 2x16x16 (pod,data,model)\n")
    print("\n".join(dryrun_table(recs, "mp")))
    print("\n## Roofline (single pod, whole program)\n")
    print("\n".join(roofline_table(recs)))
    for tag in sorted(t for t in recs if t.startswith("ngdb")):
        if "error" not in recs[tag]:
            print(f"\n## NGDB (the paper's model) production cell: {tag}\n")
            print(json.dumps(recs[tag], indent=1)[:2000])


if __name__ == "__main__":
    main()
