"""Roofline terms of a dry-run cell, as the JAX package's
``launch/roofline.py`` has them, with an H100's constants.

Three terms per (arch × shape × mesh), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = nvlink_wire_bytes / NVLINK_BW + ib_wire_bytes / IB_BW

The constants are an H100 SXM's published peaks at a 700 W power limit
(NVIDIA's data sheet), not measurements. Hosts are contiguous blocks of 8
ranks in row-major mesh order (``distributed.context.HOST_RANKS``): a
collective whose group lies within one host goes over NVLink, one whose
group spans hosts over InfiniBand (one 400 Gb/s NIC a card). On the 16×16
mesh a ``model`` group of 16 spans two hosts.

The reference parses collectives out of XLA's partitioned HLO
(``parse_collectives``); the port issues its collectives itself, so
``collective_stats`` prices the ``VirtualMesh``'s log with the same ring
factors (``_wire_bytes``) and records the wire bytes of each tier.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Union

# H100 SXM, published (NVIDIA's data sheet, dense), at a 700 W power limit.
PEAK_FLOPS = 989e12        # bf16 on the tensor cores
HBM_BW = 3.35e12           # bytes/s
NVLINK_BW = 450e9          # bytes/s each way per card, within a host of 8
IB_BW = 50e9               # bytes/s per card across hosts (one 400 Gb/s NIC)
TIERS = {"nvlink": NVLINK_BW, "ib": IB_BW}
CONSTANTS = "H100 SXM published peaks, 700 W"

# The virtual mesh's op names as XLA's collectives (a send and its recv are
# one collective-permute; the send carries it).
_HLO_OPS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
            "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
            "send": "collective-permute", "broadcast": "broadcast"}


# Ring-algorithm wire-byte factors per chip, as multiples of the RESULT size.
def _wire_bytes(op: str, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-gather":          # receive everyone else's shard
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":      # result is the local shard
        return result_bytes * (g - 1)
    if op == "all-reduce":          # RS + AG
        return 2.0 * result_bytes * (g - 1) / g
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    if op == "collective-permute":
        return float(result_bytes)
    return 0.0


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float
    payload_bytes: float
    by_type: Dict[str, float]
    counts: Dict[str, int]
    by_tier: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def collective_stats(log: Iterable[Mapping], n_dev: int) -> CollectiveStats:
    """``parse_collectives``' statistics from a ``VirtualMesh`` log: each
    entry's result bytes priced by its op's ring factor over its group (the
    whole mesh of ``n_dev`` where an entry names none), summed by type and
    by tier (``ib`` where the group spans hosts, else ``nvlink``)."""
    by_type: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    by_tier = {t: 0.0 for t in TIERS}
    wire = payload = 0.0
    for e in log:
        op = _HLO_OPS.get(e["op"])
        if op is None:
            continue
        size = e["result_bytes"]
        w = _wire_bytes(op, size, e.get("group", n_dev))
        wire += w
        payload += size
        by_type[op] = by_type.get(op, 0.0) + w
        counts[op] = counts.get(op, 0) + 1
        by_tier["ib" if e.get("spans_hosts") else "nvlink"] += w
    return CollectiveStats(wire, payload, by_type, counts, by_tier)


def roofline_terms(flops: float, bytes_accessed: float,
                   wire_bytes: Union[float, Mapping[str, float]]) -> Dict:
    """The three terms and the dominant one. ``wire_bytes`` is a
    ``CollectiveStats.by_tier`` mapping, or one figure taken as NVLink's."""
    tiers = dict(wire_bytes) if isinstance(wire_bytes, Mapping) else {"nvlink": wire_bytes}
    tier_s = {f"{t}_s": tiers.get(t, 0.0) / bw for t, bw in TIERS.items()}
    compute_t = flops / PEAK_FLOPS
    memory_t = bytes_accessed / HBM_BW
    coll_t = sum(tier_s.values())
    terms = {"compute_s": compute_t, "memory_s": memory_t, "collective_s": coll_t}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = max(bound, 1e-30)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "bound_s": bound,
        "roofline_fraction_compute": compute_t / total,
        "collective_tiers": tier_s,
        "constants": CONSTANTS,
    }


def model_flops(cfg, shape_cell, kind: str) -> float:
    """Analytic useful FLOPs per step: 6·N·D train, 2·N·D forward-only
    (MoE: N_active)."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = shape_cell.global_batch * shape_cell.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape_cell.global_batch * shape_cell.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence (attention reads the cache; the 2·N·D
    # matmul term is the useful-work yardstick)
    return 2.0 * n * shape_cell.global_batch
