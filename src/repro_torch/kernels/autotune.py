"""Kernel autotuner with a persisted tuning cache, over the CUDA kernels'
launch geometries.

The port's counterpart of ``src/repro/kernels/autotune.py``. The TPU
kernels there take tile shapes; the port's kernels each take one launch
geometry knob, and by design no choice of it changes a bit of the output:

* ``scoring`` — ``tile``: 16 or 4 entity rows per consumer warp
  (``csrc/scoring.cu``);
* ``intersect`` — ``rows``: the pool rows of a cluster's row group
  (``csrc/intersect.cu``; the kernel's own choice is ``group_rows(k)``);
* ``gather_fuse`` — ``rows``: 128 rows a block (the pair kernel) or 64 and
  a column pass a block (the split kernel) (``csrc/gather_fuse.cu``).

A knob of 0 is the kernel's own choice for the exact shape on its card (the
rule it applied before this module existed), and ``DEFAULTS`` holds 0 for
every op: with no tuned entry a launch, a plan and every bit are what they
were without a tuner.

This module searches the knob per **(op, shape bucket, dtype, device)** and
persists the winner, so tuning is paid once per card:

* **Shape buckets** — pool-rows dimensions are bucketed to the next power
  of two (the ladder the scheduler's ``bucket_size`` pads to), feature dims
  are kept exact (the shape math is the reference's, copied exactly).
* **Device** — the key's device is ``torch.cuda.get_device_name()`` for a
  CUDA tensor, or ``cpu``: a CPU timing never serves a card, and one card's
  tuning never serves another.
* **Bit-identity** — the default (knob 0) runs first and its output is the
  oracle; a candidate whose output is not ``torch.equal`` to it is rejected
  (``verify_rejects``) before any candidate is timed.
* **Timed sweep** — through the PUBLIC wrappers (the code production
  runs): on the card, CUDA events around each call with a 512 MB buffer
  zeroed before it (the card stays busy while the host enqueues, so the
  host's launch cost stays out, and L2 starts cold, as in
  ``kernels/timing.py``); on the CPU, the host clock. The statistic is the
  **minimum** over ``iters`` calls, after ``warmup`` calls, as in the
  reference: noise only adds time. Unlike the reference, the candidates are
  timed in interleaved rounds, so that a burst of host stalls cannot fill
  every sample of one candidate (the default most of all, timed first). A challenger must beat the default by
  ``margin`` (10%), so ties and noise stay with the default and the tuned
  time is never above the default's.
* **Persisted cache** — crash-safe JSON (tmp + fsync + ``os.replace``). A
  corrupt, partial, foreign-version or malformed file is rejected whole
  (``load_error`` says why) and retuned, never crashed on.
  ``REPRO_TORCH_AUTOTUNE_CACHE`` names the default cache file of the
  process tuner. It is not the reference's ``REPRO_AUTOTUNE_CACHE``: a
  process that loads both packages would otherwise have each tuner reject,
  and then overwrite, the other's file (their knobs differ).

``PoolTilePolicy`` is the bridge to the compiler: it maps a scheduler pool
``(op, cardinality, rows)`` to the tuned row tile, and
``scheduler.bucket_size`` pads the pool to the smallest multiple of that
tile instead of the bare power of two (n = 288 with a 64-row tile pads to
320, not 512), with the policy's key in every schedule and plan cache key.
A tuned ``rows`` of ``intersect`` or ``gather_fuse`` is such a tile; an
entry whose config is the kernel's own default gives none.

Activity is published through the registry (group ``autotune``): sweeps
run, candidates timed, lookups served tuned or default, rejected
candidates, cache-file loads, rejected loads and saves, and the entries.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.obs.registry import get_registry

__all__ = [
    "DEFAULTS", "KernelTuner", "PoolTilePolicy", "get_tuner", "set_tuner",
    "pow2ceil", "ceil_to", "rows_bucket", "row_block", "scoring_bucket",
    "intersect_bucket", "gather_fuse_bucket", "cache_key", "device_kind",
    "tuned_config", "pool_tile_policy", "tune_for_model", "ENV_CACHE",
]

#: The knob every op takes, 0 being the kernel's own choice: what an empty
#: tuner serves, so that it changes no launch.
DEFAULTS: Dict[str, Dict[str, int]] = {
    "scoring": {"tile": 0},
    "intersect": {"rows": 0},
    "gather_fuse": {"rows": 0},
}

ENV_CACHE = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1
#: The least entity-rows bucket of a scoring shape (the reference's floor).
SCORING_ROWS_FLOOR = 128


# --------------------------------------------------------------- shape math
def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def ceil_to(n: int, m: int) -> int:
    """Smallest multiple of m >= n."""
    return -(-int(n) // int(m)) * int(m)


def rows_bucket(n: int, floor: int = 8) -> int:
    """Pow2 bucket for a rows-like dimension, floored at the minimum block."""
    return max(int(floor), pow2ceil(n))


def row_block(n: int, tile: int, floor: int = 8) -> Tuple[int, int]:
    """The row-padding rule of the compiler's kernel-aware ``bucket_size``:
    clamp the tuned ``tile`` to the pow2 bucket of ``n`` (a tile can never
    exceed the padded rows), then pad ``n`` to the smallest multiple of the
    clamped block. Returns ``(block, padded_n)`` with
    ``padded_n % block == 0``."""
    b = min(int(tile), rows_bucket(n, floor))
    return b, ceil_to(max(int(n), 1), b)


def scoring_bucket(B: int, N: int, d: int) -> Tuple[int, int, int]:
    return (rows_bucket(B), rows_bucket(N, SCORING_ROWS_FLOOR), int(d))


def intersect_bucket(n: int, k: int, d: int, hd: int) -> Tuple[int, ...]:
    return (rows_bucket(n), int(k), int(d), int(hd))


def gather_fuse_bucket(n: int, d: int, dl: int, dp: int) -> Tuple[int, ...]:
    return (rows_bucket(n, 1), int(d), int(dl), int(dp))


_BUCKETS: Dict[str, Callable] = {
    "scoring": scoring_bucket,
    "intersect": intersect_bucket,
    "gather_fuse": gather_fuse_bucket,
}

_KINDS: Dict[int, str] = {}


def device_kind(device) -> str:
    """``cpu``, or the name of the CUDA card ``device`` names (read once a
    card): the device part of a cache key."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"autotune: no kernels run on {dev}")
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    kind = _KINDS.get(idx)
    if kind is None:
        kind = _KINDS[idx] = torch.cuda.get_device_name(idx)
    return kind


def dtype_name(dtype: torch.dtype) -> str:
    """``float32``, ``bfloat16``: the reference's dtype strings."""
    return str(dtype).removeprefix("torch.")


def cache_key(op: str, bucket: Sequence[int], dtype: str, device: str) -> str:
    """Flat string key: op | shape bucket | dtype | device kind (a card's
    name or ``cpu``)."""
    shp = "x".join(str(int(v)) for v in bucket)
    return f"{op}|{shp}|{dtype}|{device}"


def _valid_config(op: str, cfg) -> bool:
    """A config of the op's knob with a value the kernel takes."""
    if not isinstance(cfg, dict) or set(cfg) != set(DEFAULTS[op]):
        return False
    v = next(iter(cfg.values()))
    if not isinstance(v, int) or isinstance(v, bool):
        return False
    if op == "scoring":
        return v in (0, 16, 4)
    if op == "gather_fuse":
        return v in (0, 64, 128)
    return v >= 0


# ----------------------------------------------------------- search spaces
def scoring_candidates(bucket, default: Optional[int] = None) -> List[Dict[str, int]]:
    """The kernel's choice first, then each tiling it would not choose
    (``default``: the tiling it takes at the bucket on this card; None on
    the CPU, where every tiling is listed)."""
    from repro_torch.kernels.scoring import TILES

    return [{"tile": 0}] + [{"tile": t} for t in TILES if t != default]


def intersect_candidates(bucket, default: Optional[int] = None) -> List[Dict[str, int]]:
    """The kernel's choice (``group_rows(k)`` pool rows a row group) first,
    then every power of two below it and below the bucket's rows: a group
    of as many rows as the pool, or more, launches as the default does."""
    from repro_torch.kernels.intersect import group_rows

    nb, k = int(bucket[0]), int(bucket[1])
    top = min(group_rows(k), nb)
    out, r = [{"rows": 0}], 1
    while r < top:
        out.append({"rows": r})
        r *= 2
    return out


def gather_fuse_candidates(bucket, default: Optional[int] = None) -> List[Dict[str, int]]:
    """The kernel's choice first, then each kernel it would not choose (128:
    the pair kernel, 64: the split kernel; ``default`` as for scoring)."""
    return [{"rows": 0}] + [{"rows": r} for r in (128, 64) if r != default]


_CANDIDATES: Dict[str, Callable] = {
    "scoring": scoring_candidates,
    "intersect": intersect_candidates,
    "gather_fuse": gather_fuse_candidates,
}


def candidates(op: str, bucket, default: Optional[int] = None) -> List[Dict[str, int]]:
    """The configs a sweep of ``op`` at ``bucket`` tries, the default (0)
    first; ``default`` is ``kernel_default``'s answer on the card."""
    return _CANDIDATES[op](bucket, default)


def kernel_default(op: str, bucket, device) -> Optional[int]:
    """The knob the kernel itself takes at the bucket's shape on ``device``'s
    card, read from the kernel library (None on the CPU)."""
    if torch.device(device).type == "cpu":
        return None
    from repro_torch.kernels import build

    lib = build.load_library()
    with torch.cuda.device(device):
        if op == "scoring":
            v = lib.repro_scoring_tile(int(bucket[1]))
        elif op == "gather_fuse":
            v = lib.repro_gather_fuse_rows(int(bucket[0]))
        else:
            v = lib.repro_intersect_group_rows(int(bucket[1]), 0)
    build.check(lib, max(0, -v), f"{op} default")
    return v


# ------------------------------------------------------------------- tuner
@dataclasses.dataclass
class SweepResult:
    key: str
    config: Dict[str, int]
    us: float
    default_us: float
    n_candidates: int
    n_rejected: int
    default: Optional[int]


class KernelTuner:
    """Per-process knob tuner + the persisted on-disk tuning cache.

    Lookups (``config_for``) are a dict probe, safe on every launch; an
    empty tuner answers without building a key. The sweep runs only when
    ``tune()`` / ``tune_for_model()`` is called (``--autotune``,
    ``chip_smoke.py``, a test). With no tuned entries the tuner serves
    ``DEFAULTS`` and every launch is the kernel's own choice."""

    def __init__(self, path: Optional[str] = None, iters: int = 3,
                 warmup: int = 1, margin: float = 0.10):
        if iters < 1 or warmup < 0:
            raise ValueError(f"iters >= 1 and warmup >= 0 required; got "
                             f"iters={iters} warmup={warmup}")
        if not 0.0 <= margin < 1.0:
            raise ValueError(f"margin must be in [0, 1); got {margin}")
        self.path = path
        self.iters = iters
        self.warmup = warmup
        self.margin = margin
        self._entries: Dict[str, Dict] = {}
        self._lock = threading.RLock()
        self.load_error: Optional[str] = None
        m = get_registry().group("autotune")
        self.sweeps = m.counter("sweeps")
        self.candidates_timed = m.counter("candidates_timed")
        self.lookup_hits = m.counter("lookup_hits")      # tuned config served
        self.lookup_misses = m.counter("lookup_misses")  # DEFAULTS served
        self.verify_rejects = m.counter("verify_rejects")
        self.loads = m.counter("loads")
        self.load_rejects = m.counter("load_rejects")
        self.saves = m.counter("saves")
        self.entries_gauge = m.gauge("entries")
        if path:
            self.load()

    # ------------------------------------------------------------- lookups
    def lookup(self, op: str, bucket, dtype: str = "float32",
               device="cpu") -> Optional[Dict[str, int]]:
        key = cache_key(op, bucket, dtype, device_kind(device))
        with self._lock:
            e = self._entries.get(key)
        return dict(e["config"]) if e else None

    def config_for(self, op: str, bucket, dtype: str = "float32",
                   device="cpu") -> Dict[str, int]:
        """Tuned config for the bucket, or the default (the kernel's own
        choice)."""
        c = self.lookup(op, bucket, dtype, device) if self._entries else None
        if c is not None:
            self.lookup_hits += 1
            return c
        self.lookup_misses += 1
        return dict(DEFAULTS[op])

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __bool__(self) -> bool:
        # An empty tuner is still a tuner: never let ``len == 0`` make
        # ``tuner or get_tuner()``-style code swap in the global one.
        return True

    def entries(self) -> Dict[str, Dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def stats(self) -> Dict:
        with self._lock:
            n = len(self._entries)
        return {
            "name": "autotune",
            "path": self.path,
            "entries": n,
            "sweeps": int(self.sweeps),
            "candidates_timed": int(self.candidates_timed),
            "lookup_hits": int(self.lookup_hits),
            "lookup_misses": int(self.lookup_misses),
            "verify_rejects": int(self.verify_rejects),
            "loads": int(self.loads),
            "load_rejects": int(self.load_rejects),
            "saves": int(self.saves),
            "load_error": self.load_error,
        }

    # ------------------------------------------------------------ sweeping
    def tune(self, op: str, bucket, dtype: str = "float32", device=None,
             force: bool = False) -> Dict[str, int]:
        """Ensure a tuned entry for the bucket on ``device`` (``cuda``
        unless given; sweep once, then cached in memory and, with a
        ``path``, on disk)."""
        if op not in _CANDIDATES:
            raise ValueError(f"unknown op {op!r}; tunable: {sorted(_CANDIDATES)}")
        dev = resolve_device(device)
        bucket = tuple(int(v) for v in bucket)
        kind = device_kind(dev)
        key = cache_key(op, bucket, dtype, kind)
        with self._lock:
            if not force and key in self._entries:
                return dict(self._entries[key]["config"])
        res = self._sweep(op, bucket, dtype, dev)
        with self._lock:
            self._entries[key] = {
                "op": op, "bucket": list(bucket), "dtype": dtype,
                "device": kind, "config": dict(res.config), "us": res.us,
                "default_us": res.default_us, "default": res.default,
                "n_candidates": res.n_candidates,
                "n_rejected": res.n_rejected,
            }
            self.entries_gauge.set(len(self._entries))
        if self.path:
            self.save()
        return dict(res.config)

    def _sweep(self, op, bucket, dtype, device) -> SweepResult:
        self.sweeps += 1
        run, args = make_runner(op, bucket, dtype, device)
        default = kernel_default(op, bucket, device)
        cands = candidates(op, bucket, default)
        ref_out = run(cands[0], *args)  # the kernel's own choice = oracle
        flush = None
        if device.type == "cuda":
            from repro_torch.kernels.timing import flush_buffer

            flush = flush_buffer(device)
        ok, rejected = [], 0
        for cfg in cands:
            if torch.equal(run(cfg, *args), ref_out):
                ok.append(cfg)
            else:
                # A geometry may only move work, never numerics.
                self.verify_rejects += 1
                rejected += 1
        if not ok:
            raise RuntimeError(f"autotune: no {op} candidate at {bucket} repeats its output")
        times = _time_us([lambda c=c: run(c, *args) for c in ok], self.iters,
                         self.warmup, flush)
        self.candidates_timed += len(ok)
        # The default runs first; it is the incumbent to beat. A challenger
        # must beat it by ``margin`` (not just by a timer tick): ties and
        # noise stay with the default.
        default_us = best_us = times[0]
        best_cfg = dict(ok[0])
        for cfg, us in zip(ok[1:], times[1:]):
            if us < best_us and us < default_us * (1.0 - self.margin):
                best_cfg, best_us = dict(cfg), us
        return SweepResult(
            key=cache_key(op, bucket, dtype, device_kind(device)), config=best_cfg,
            us=float(best_us), default_us=float(default_us),
            n_candidates=len(cands), n_rejected=rejected, default=default)

    # --------------------------------------------------------- persistence
    def save(self) -> None:
        """Crash-safe publish: tmp + fsync + atomic rename; a reader never
        sees partial bytes."""
        if not self.path:
            return
        with self._lock:
            payload = {"version": CACHE_VERSION, "entries": dict(self._entries)}
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self.saves += 1

    def load(self) -> int:
        """Load the persisted cache; a corrupt, partial, foreign-version or
        malformed file is rejected whole (``load_error`` records why) and
        the tuner simply retunes: it never raises."""
        self.load_error = None
        if not self.path or not os.path.exists(self.path):
            return 0
        try:
            with open(self.path) as f:
                payload = json.load(f)
            if not isinstance(payload, dict):
                raise ValueError("cache root is not an object")
            if payload.get("version") != CACHE_VERSION:
                raise ValueError(
                    f"cache version {payload.get('version')!r} != "
                    f"{CACHE_VERSION}")
            raw = payload.get("entries")
            if not isinstance(raw, dict):
                raise ValueError("cache has no entries object")
            good: Dict[str, Dict] = {}
            for k, e in raw.items():
                if (isinstance(k, str) and isinstance(e, dict)
                        and e.get("op") in DEFAULTS
                        and _valid_config(e["op"], e.get("config"))):
                    good[k] = e
                else:
                    raise ValueError(f"malformed entry {k!r}")
        except (OSError, ValueError, UnicodeDecodeError) as err:
            self.load_error = f"{type(err).__name__}: {err}"
            self.load_rejects += 1
            return 0
        with self._lock:
            self._entries.update(good)
            self.entries_gauge.set(len(self._entries))
        self.loads += 1
        return len(good)


def _time_us(fns: Sequence[Callable], iters: int, warmup: int,
             flush: Optional[torch.Tensor]) -> List[float]:
    """The minimum over ``iters`` calls of each of ``fns``, in µs, after
    ``warmup`` calls of each: device time between CUDA events with ``flush``
    zeroed before each call on the card, the host clock on the CPU
    (``flush`` None). The calls go in ``iters`` interleaved rounds, each
    round a rotation of ``fns``: a host stall that outlasts the flush lands
    in one round of every candidate, not in every sample of one."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    n = len(fns)
    samples: List[List] = [[] for _ in range(n)]
    for r in range(iters):
        for i in (*range(r % n, n), *range(r % n)):
            if flush is None:
                t0 = time.perf_counter()
                fns[i]()
                samples[i].append((time.perf_counter() - t0) * 1e6)
                continue
            flush.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fns[i]()
            e.record()
            samples[i].append((s, e))
    if flush is None:
        return [min(ts) for ts in samples]
    torch.cuda.synchronize()
    return [min(s.elapsed_time(e) for s, e in pairs) * 1e3 for pairs in samples]


def make_runner(op: str, bucket, dtype: str, device: torch.device):
    """Deterministic inputs at the bucket shape on ``device`` + a runner
    that drives the PUBLIC wrapper with an explicit candidate config: the
    sweep times exactly the code production runs."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=device).manual_seed(0)
    dt = getattr(torch, dtype)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale

    if op == "scoring":
        B, N, d = bucket
        q, e = randn(B, d).to(dt), randn(N, d).to(dt)

        def run(cfg, q, e):
            return ops.scoring(q, e, gamma=1.0, mode="dot", tile=cfg["tile"])

        return run, (q, e)
    if op == "intersect":
        n, k, d, hd = bucket
        x = randn(n, k, d).to(dt)
        w1, b1 = randn(d, hd, scale=0.2), randn(hd, scale=0.1)
        w2, b2 = randn(hd, 1, scale=0.2), torch.zeros((1,), device=device)

        def run(cfg, *a):
            return ops.intersect(*a, rows=cfg["rows"])

        return run, (x, w1, b1, w2, b2)
    if op == "gather_fuse":
        n, d, dl, dp = bucket
        E = max(n, 64)
        ids = torch.randint(0, E, (n,), generator=g, device=device)
        h_str, h_sem = randn(E, d).to(dt), randn(E, dl).to(dt)
        wp, bp = randn(dl, dp, scale=0.2), randn(dp, scale=0.1)
        wf, bf = randn(d + dp, d, scale=0.2), torch.zeros((d,), device=device)

        def run(cfg, *a):
            return ops.gather_fuse(*a, rows=cfg["rows"])

        return run, (ids, h_str, h_sem, wp, bp, wf, bf)
    raise ValueError(op)  # pragma: no cover


# ---------------------------------------------------------- process tuner
_GLOBAL: Optional[KernelTuner] = None
_GLOBAL_LOCK = threading.Lock()


def get_tuner() -> KernelTuner:
    """Process-wide tuner. Created lazily; takes ``REPRO_TORCH_AUTOTUNE_CACHE``
    as its persisted cache path when set (``launch/env.py --autotune-cache``
    sets it)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = KernelTuner(path=os.environ.get(ENV_CACHE) or None)
        return _GLOBAL


def set_tuner(tuner: Optional[KernelTuner]) -> Optional[KernelTuner]:
    """Install (or with ``None`` reset) the process-wide tuner; returns the
    previous one so tests can restore it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev, _GLOBAL = _GLOBAL, tuner
        return prev


def tuned_config(op: str, shape: Sequence[int], t: torch.Tensor) -> Dict[str, int]:
    """The process tuner's config for a launch of ``op`` at ``shape`` (the
    bucket function's arguments) on ``t``'s dtype and card: what a wrapper
    given no knob launches. An empty tuner answers with the default without
    building a key."""
    tuner = _GLOBAL if _GLOBAL is not None else get_tuner()
    if not tuner._entries:
        tuner.lookup_misses += 1
        return dict(DEFAULTS[op])
    return tuner.config_for(op, _BUCKETS[op](*shape), dtype_name(t.dtype), t.device)


# ------------------------------------------------------- compiler bridge
class PoolTilePolicy:
    """Maps a scheduler pool ``(op, cardinality, rows)`` to the tuned row
    tile its padded size must be a multiple of (``scheduler.bucket_size``
    consumes it). ``key()`` enters every schedule/plan cache key, so two
    executors holding different tunings never share a schedule: the
    signature universe stays closed per policy."""

    def __init__(self, tiles: Dict[Tuple[int, int, int], int]):
        for (op, card, bucket), t in tiles.items():
            if t < 1 or (t & (t - 1)):
                raise ValueError(
                    f"tile for pool (op={op}, card={card}, bucket={bucket}) "
                    f"must be a power of two >= 1, got {t}")
        self._tiles = dict(tiles)
        self._key = tuple(sorted(self._tiles.items()))

    def tile(self, op: int, card: int, n: int) -> int:
        if not self._tiles:
            return 1
        return self._tiles.get((int(op), int(card), rows_bucket(n, 1)), 1)

    def key(self) -> Tuple:
        return self._key

    def __bool__(self) -> bool:
        return bool(self._tiles)

    def __repr__(self) -> str:
        return f"PoolTilePolicy({len(self._tiles)} tiles)"


def pool_tile_policy(model, tuner: Optional[KernelTuner] = None,
                     b_max: int = 512, device=None) -> Optional[PoolTilePolicy]:
    """The kernel-aware padding policy for ``model`` on ``device`` (the
    model's unless given) from what the tuner has learned there. Tiles come
    from tuned entries of that device whose feature dims match the model
    (intersect/union pools on ``state_dim``; embed pools on the fused
    ``cfg.dim``) and whose config is not the kernel's own choice; with none
    (or on meta) the result is ``None`` and the compiler keeps bare pow2
    padding."""
    from repro_torch.core.ops import OpType

    dev = torch.device(model.device if device is None else device)
    if dev.type == "meta":  # the dry run: no kernel runs there, none was tuned
        return None
    tuner = get_tuner() if tuner is None else tuner
    kind = device_kind(dev)
    tiles: Dict[Tuple[int, int, int], int] = {}
    sd = int(model.state_dim)
    dim = int(model.cfg.dim)
    for e in tuner.entries().values():
        bucket = e.get("bucket") or []
        if e.get("device") != kind or len(bucket) != 4:
            continue
        rows = int(e["config"].get("rows", 0))
        nb = int(bucket[0])
        if rows == 0 or nb > rows_bucket(b_max, 1):
            continue
        if e["op"] == "intersect" and bucket[2] == sd:
            for op in (OpType.INTERSECT, OpType.UNION):
                tiles[(int(op), int(bucket[1]), nb)] = rows
        elif e["op"] == "gather_fuse" and bucket[1] == dim:
            tiles[(int(OpType.EMBED), 0, nb)] = rows
    return PoolTilePolicy(tiles) if tiles else None


def tune_for_model(model, tuner: Optional[KernelTuner] = None,
                   b_max: int = 512, batch: int = 128,
                   n_entities: int = 4096, cards: Sequence[int] = (2, 3),
                   device=None) -> int:
    """Bounded sweep over the buckets one model and shape regime hits, on
    ``device`` (``cuda`` unless given): scoring at (batch × entities × dim),
    intersect at every pool bucket the scheduler can form (8 up to
    ``b_max``) per cardinality class, gather_fuse at the embed working set.
    Returns the number of sweeps run (0 when the cache already covers
    everything)."""
    tuner = get_tuner() if tuner is None else tuner
    dev = resolve_device(device)
    before = int(tuner.sweeps)
    dim = int(model.cfg.dim)
    sd = int(model.state_dim)
    tuner.tune("scoring", scoring_bucket(batch, n_entities, dim), device=dev)
    hd = None
    # Intersect MLP width from the model's own attention params when it has
    # one (BetaE: att_w0 [2d, h]); else hidden_mult * dim.
    probe = model.init_geometry(torch.Generator(device=model.device).manual_seed(0), 8, 4)
    for name in ("att_w0", "int_w0"):
        if name in probe:
            hd = int(probe[name].shape[1])
            break
    if hd is None:
        hd = int(model.cfg.hidden_mult * dim)
    # The full pow2 ladder up to the largest pool the scheduler can form, so
    # the tile policy has an answer for every pool bucket.
    top = rows_bucket(min(4 * batch, b_max))
    pool_buckets = []
    nb = 8
    while nb <= top:
        pool_buckets.append(nb)
        nb *= 2
    for k in cards:
        for nb in pool_buckets:
            tuner.tune("intersect", intersect_bucket(nb, k, sd, hd), device=dev)
    if model.cfg.semantic_dim > 0:
        dl = int(model.cfg.semantic_dim)
        dp = int(model.cfg.semantic_proj_dim)
        tuner.tune("gather_fuse",
                   gather_fuse_bucket(min(4 * batch, b_max), dim, dl, dp),
                   device=dev)
    return int(tuner.sweeps) - before
