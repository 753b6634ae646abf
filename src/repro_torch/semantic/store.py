"""Out-of-core semantic store (§4.4): sharded on-disk H_sem and its bounded
device hot set.

* ``SemanticStoreWriter`` / ``precompute_semantic_table_to_store`` — stream
  the offline PTE encode shard by shard onto disk; host memory stays
  O(shard_rows x d_l), never O(E x d_l). Shards are written crash-safely
  (tmp file + fsync + atomic rename, ``meta.json`` published last) in either
  a raw fp32 layout or an int8 layout with one fp32 scale per row.
* ``SemanticStore`` — read side: validates shard completeness on open
  (partial or truncated shards are rejected), memory-maps shards lazily and
  serves ``read_rows(ids)`` gathers with on-the-fly dequantization;
  ``append_rows`` grows it in place, crash-safely, for live entity writes.
* ``SemanticCache`` — a bounded DEVICE-resident hot set of rows behind an
  entity-id -> cache-slot indirection (``sem_slot``), with CLOCK
  (second-chance) eviction and hit/miss/eviction counters. The gather
  becomes ``sem_cache[sem_slot[ids]]`` instead of ``sem_table[ids]``, so the
  device holds ``budget_rows x d_l x 4`` semantic bytes plus the int32
  indirection, independent of E.

The on-disk format is the JAX package's, byte for byte (``meta.json``
version 1, the same shard layouts): a store either package writes opens in
the other.

Threading contract: ``plan()`` does the store I/O, the dequantization and
the single host->device copy of the missing rows; ``apply_to()`` writes them
into the cache in place, on the current CUDA stream of the thread that owns
the step launches (the serving batcher, the trainer's main thread). Because
that stream executes in order, an apply enqueued after batch *k*'s kernels
cannot clobber rows batch *k* reads, even when eviction reuses their slots
for batch *k+1* (or for a batch still queued behind it). ``plan()`` runs
either on that same thread (a sync stage) or on the training pipeline's
scheduler thread (``plan(background=True, stream=side)``): then the rows are
packed into pinned memory and copied on the side stream without blocking,
and ``apply_to`` makes the current stream wait on the stage's event first.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.plan import packed_to_device
from repro_torch.device import resolve_device
from repro_torch.obs.registry import get_registry
from repro_torch.obs.trace import TRACER

_META = "meta.json"
_VERSION = 1


class SemanticStoreError(RuntimeError):
    """Raised for missing/partial/corrupt stores (crash-safe open contract)."""


def _shard_name(i: int) -> str:
    return f"shard_{i:05d}.bin"


def _shard_nbytes(rows: int, dim: int, quant: str) -> int:
    if quant == "fp32":
        return rows * dim * 4
    if quant == "int8":
        return rows * dim + rows * 4  # int8 data then one fp32 scale per row
    raise SemanticStoreError(f"unknown quant layout {quant!r}")


def quantize_int8(rows: np.ndarray):
    """Per-row symmetric int8: q = round(x / s), s = max|row| / 127.

    Round-trip error is bounded by s/2 = max|row|/254 per element.
    """
    rows = np.asarray(rows, dtype=np.float32)
    scale = np.abs(rows).max(axis=1) / 127.0
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(rows / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale[:, None]


def _write_atomic(path: str, payload: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic publish: readers never see partial bytes


class SemanticStoreWriter:
    """Streaming shard writer. ``append`` buffers at most one shard of rows;
    ``finalize`` publishes ``meta.json`` LAST, so a crash at any point leaves
    either a complete store or one ``SemanticStore`` refuses to open."""

    def __init__(self, directory: str, dim: int, quant: str = "fp32",
                 shard_rows: int = 65536):
        if quant not in ("fp32", "int8"):
            raise SemanticStoreError(f"quant must be fp32|int8, got {quant!r}")
        if shard_rows < 1:
            raise SemanticStoreError("shard_rows must be >= 1")
        self.directory = directory
        self.dim = dim
        self.quant = quant
        self.shard_rows = shard_rows
        self._buf: List[np.ndarray] = []
        self._buf_rows = 0
        self._shards: List[Dict] = []
        self._finalized = False
        os.makedirs(directory, exist_ok=True)
        # Rebuilding over an existing store: invalidate it FIRST, or a crash
        # mid-rebuild leaves the old meta.json over a mix of old and new
        # shard files with plausible byte counts.
        stale_meta = os.path.join(directory, _META)
        if os.path.exists(stale_meta):
            os.remove(stale_meta)

    def append(self, rows: np.ndarray) -> None:
        assert not self._finalized
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        assert rows.ndim == 2 and rows.shape[1] == self.dim, rows.shape
        self._buf.append(rows)
        self._buf_rows += len(rows)
        while self._buf_rows >= self.shard_rows:
            block = np.concatenate(self._buf, axis=0)
            self._flush_shard(block[: self.shard_rows])
            rest = block[self.shard_rows:]
            self._buf = [rest] if len(rest) else []
            self._buf_rows = len(rest)

    def _flush_shard(self, block: np.ndarray) -> None:
        if self.quant == "fp32":
            payload = np.ascontiguousarray(block, dtype=np.float32).tobytes()
        else:
            q, scale = quantize_int8(block)
            payload = q.tobytes() + scale.tobytes()
        name = _shard_name(len(self._shards))
        _write_atomic(os.path.join(self.directory, name), payload)
        self._shards.append({"file": name, "rows": int(len(block)),
                             "nbytes": len(payload)})

    def finalize(self) -> None:
        if self._buf_rows:
            self._flush_shard(np.concatenate(self._buf, axis=0))
            self._buf, self._buf_rows = [], 0
        meta = {
            "version": _VERSION,
            "n_rows": int(sum(s["rows"] for s in self._shards)),
            "dim": int(self.dim),
            "quant": self.quant,
            "shard_rows": int(self.shard_rows),
            "shards": self._shards,
        }
        _write_atomic(os.path.join(self.directory, _META),
                      json.dumps(meta, indent=1).encode())
        self._finalized = True


class SemanticStore:
    """Read side of the sharded on-disk H_sem. Opening validates the store:
    every shard listed in ``meta.json`` must exist with exactly the expected
    byte count — a crashed or partial write is detected and rejected."""

    def __init__(self, directory: str):
        self.directory = directory
        self._lock = threading.Lock()
        self.reload()

    def reload(self) -> None:
        """Read ``meta.json`` again: rows another process appended since this
        reader opened (``append_rows`` under a mesh runs on rank 0 alone)
        become readable. Validated as at opening."""
        directory = self.directory
        meta_path = os.path.join(directory, _META)
        if not os.path.isfile(meta_path):
            raise SemanticStoreError(
                f"no semantic store at {directory!r} (missing {_META}; "
                "an interrupted precompute leaves no meta — rebuild)")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("version") != _VERSION:
            raise SemanticStoreError(f"unsupported store version {meta.get('version')}")
        self.n_rows = int(meta["n_rows"])
        self.dim = int(meta["dim"])
        self.quant = str(meta["quant"])
        self.shard_rows = int(meta["shard_rows"])
        self._shards = meta["shards"]
        row_count = 0
        for s in self._shards:
            path = os.path.join(directory, s["file"])
            expect = _shard_nbytes(s["rows"], self.dim, self.quant)
            if expect != s["nbytes"]:
                raise SemanticStoreError(f"inconsistent meta for {s['file']}")
            if not os.path.isfile(path):
                raise SemanticStoreError(f"missing shard {s['file']}")
            actual = os.path.getsize(path)
            if actual != expect:
                raise SemanticStoreError(
                    f"partial shard {s['file']}: {actual} bytes, expected "
                    f"{expect} — store is corrupt/incomplete, rebuild it")
            row_count += s["rows"]
        if row_count != self.n_rows:
            raise SemanticStoreError("meta row count does not match shards")
        with self._lock:
            self._mmaps: Dict[int, tuple] = {}

    def _shard(self, i: int):
        """Lazily mmap shard ``i`` -> (data_view, scale_view_or_None)."""
        with self._lock:
            got = self._mmaps.get(i)
            if got is not None:
                return got
            s = self._shards[i]
            path = os.path.join(self.directory, s["file"])
            rows = s["rows"]
            if self.quant == "fp32":
                got = (np.memmap(path, dtype=np.float32, mode="r",
                                 shape=(rows, self.dim)), None)
            else:
                q = np.memmap(path, dtype=np.int8, mode="r",
                              shape=(rows, self.dim))
                scale = np.memmap(path, dtype=np.float32, mode="r",
                                  offset=rows * self.dim, shape=(rows,))
                got = (q, scale)
            self._mmaps[i] = got
            return got

    def read_rows(self, ids: np.ndarray) -> np.ndarray:
        """Gather rows by entity id -> host fp32 [n, dim] (dequantized)."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if len(ids) and (ids.min() < 0 or ids.max() >= self.n_rows):
            raise IndexError(f"ids out of range [0, {self.n_rows})")
        out = np.empty((len(ids), self.dim), dtype=np.float32)
        shard_of = ids // self.shard_rows
        for i in np.unique(shard_of):
            sel = shard_of == i
            local = ids[sel] - i * self.shard_rows
            data, scale = self._shard(int(i))
            if scale is None:
                out[sel] = data[local]
            else:
                out[sel] = dequantize_int8(np.asarray(data[local]),
                                           np.asarray(scale[local]))
        return out

    def iter_shards(self) -> Iterable[tuple]:
        """Yield (row_lo, fp32 rows) per shard — the bulk scan (e.g.
        materializing a full-resident table) with at most one shard in
        memory."""
        lo = 0
        for i, s in enumerate(self._shards):
            data, scale = self._shard(i)
            rows = (np.asarray(data, dtype=np.float32) if scale is None
                    else dequantize_int8(np.asarray(data), np.asarray(scale)))
            yield lo, rows
            lo += s["rows"]

    @property
    def disk_nbytes(self) -> int:
        return sum(s["nbytes"] for s in self._shards)

    # ------------------------------------------------------------ live append
    def append_rows(self, rows: np.ndarray) -> range:
        """Crash-safe in-place append for live entity writes. Returns the id
        range of the new rows.

        The ``read_rows`` gather assumes UNIFORM geometry — every shard
        except the last holds exactly ``shard_rows`` rows — so an append
        first tops up the partial last shard, then emits fresh full/partial
        shards:

        * each payload goes through ``_write_atomic`` (tmp + fsync + atomic
          rename), so no file is ever partially visible;
        * the topped-up last shard is written under a NEW revision-suffixed
          name (``shard_NNNNN.rK.bin``) — rewriting the old file in place
          would make a crash between file and meta unopenable;
        * ``meta.json`` is published LAST: a crash before it leaves the old
          meta pointing at untouched old files; a crash after it leaves the
          new state fully on disk.

        Existing rows keep their EXACT stored bytes: the int8 merge
        concatenates the old quantized payload with newly quantized rows —
        never dequantize/requantize — so pre-append reads stay bitwise the
        same after the append."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise SemanticStoreError(
                f"append rows shape {rows.shape} != (n, {self.dim})")
        if len(rows) == 0:
            return range(self.n_rows, self.n_rows)
        with self._lock:
            shards = [dict(s) for s in self._shards]
            superseded: List[str] = []
            merged_idx = None
            pos = 0
            if shards and shards[-1]["rows"] < self.shard_rows:
                last = shards[-1]
                merged_idx = len(shards) - 1
                take = min(self.shard_rows - last["rows"], len(rows))
                block = rows[:take]
                pos = take
                with open(os.path.join(self.directory, last["file"]), "rb") as f:
                    raw = f.read()
                if len(raw) != last["nbytes"]:
                    raise SemanticStoreError(
                        f"shard {last['file']} changed size on disk")
                if self.quant == "fp32":
                    payload = raw + block.tobytes()
                else:
                    q, scale = quantize_int8(block)
                    split = last["rows"] * self.dim
                    payload = (raw[:split] + q.tobytes()
                               + raw[split:] + scale.tobytes())
                stem, rev = last["file"][: -len(".bin")], 0
                if ".r" in stem:
                    stem, _, r = stem.rpartition(".r")
                    rev = int(r)
                name = f"{stem}.r{rev + 1}.bin"
                _write_atomic(os.path.join(self.directory, name), payload)
                superseded.append(last["file"])
                shards[-1] = {"file": name, "rows": last["rows"] + take,
                              "nbytes": len(payload)}
            while pos < len(rows):
                block = rows[pos: pos + self.shard_rows]
                pos += len(block)
                if self.quant == "fp32":
                    payload = block.tobytes()
                else:
                    q, scale = quantize_int8(block)
                    payload = q.tobytes() + scale.tobytes()
                name = _shard_name(len(shards))
                _write_atomic(os.path.join(self.directory, name), payload)
                shards.append({"file": name, "rows": int(len(block)),
                               "nbytes": len(payload)})
            new_n = self.n_rows + len(rows)
            meta = {
                "version": _VERSION,
                "n_rows": int(new_n),
                "dim": int(self.dim),
                "quant": self.quant,
                "shard_rows": int(self.shard_rows),
                "shards": shards,
            }
            _write_atomic(os.path.join(self.directory, _META),
                          json.dumps(meta, indent=1).encode())
            # Publish point passed: swap the in-memory state and retire the
            # superseded mapping and file (a reader elsewhere may still hold
            # the old mapping; the unlink only drops the name).
            old_n = self.n_rows
            self.n_rows = new_n
            self._shards = shards
            if merged_idx is not None:
                self._mmaps.pop(merged_idx, None)
            for f in superseded:
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass
            return range(old_n, new_n)


# --------------------------------------------------------------------------
# Streaming offline precompute (Eq. 10) — never holds [E, d_l] in host RAM.
# --------------------------------------------------------------------------

def precompute_semantic_table_to_store(
    kg,
    directory: str,
    pte=None,
    batch_size: int = 256,
    unload: bool = True,
    smooth: float = 0.5,
    quant: str = "fp32",
    shard_rows: int = 65536,
) -> SemanticStore:
    """Streaming twin of ``semantic/pte.py::precompute_semantic_table``:
    encodes shard by shard to disk and (in fp32 mode) produces bit-identical
    rows to the in-memory version — same encode batch boundaries, same
    per-row neighbor-smoothing accumulation order, same dtypes.

    Host memory is O(shard_rows x d_l): pass 1 streams normalized encodings
    into an on-disk staging memmap; pass 2 computes one output shard at a
    time, gathering the neighbor rows it needs from the staging file."""
    from repro_torch.semantic.pte import StubPTE, encode_normalized_batches

    pte = pte or StubPTE()
    E = kg.n_entities
    dim = pte.cfg.d_l
    writer = SemanticStoreWriter(directory, dim, quant=quant,
                                 shard_rows=shard_rows)

    stage_path = os.path.join(directory, "stage1.tmp")
    stage = np.memmap(stage_path, dtype=np.float32, mode="w+", shape=(E, dim))
    try:
        lo = 0
        for block in encode_normalized_batches(kg, pte, batch_size):
            stage[lo: lo + len(block)] = block
            lo += len(block)
        stage.flush()

        if smooth > 0:
            heads = kg.triples[:, 0]
            tails = kg.triples[:, 2]
            cnt = np.ones((E, 1))  # float64, matching the in-memory version
            np.add.at(cnt, heads, 1.0)
            np.add.at(cnt, tails, 1.0)
            for slo in range(0, E, shard_rows):
                shi = min(slo + shard_rows, E)
                nb = np.zeros((shi - slo, dim), dtype=np.float32)
                mask = (heads >= slo) & (heads < shi)
                np.add.at(nb, heads[mask] - slo, stage[tails[mask]])
                mask = (tails >= slo) & (tails < shi)
                np.add.at(nb, tails[mask] - slo, stage[heads[mask]])
                block = stage[slo:shi] + smooth * nb / cnt[slo:shi]
                block /= np.linalg.norm(block, axis=1, keepdims=True) + 1e-6
                writer.append(block.astype(np.float32))
        else:
            for slo in range(0, E, shard_rows):
                writer.append(np.asarray(stage[slo: min(slo + shard_rows, E)]))
        writer.finalize()
    finally:
        del stage
        if os.path.exists(stage_path):
            os.remove(stage_path)
    if unload:
        pte.unload()
    return SemanticStore(directory)


# --------------------------------------------------------------------------
# Device-resident hot-set cache
# --------------------------------------------------------------------------

class _ArrayReader:
    """Adapter so tests can back a cache by an in-memory table."""

    def __init__(self, table: np.ndarray):
        self._t = np.asarray(table, dtype=np.float32)
        self.n_rows, self.dim = self._t.shape

    def read_rows(self, ids: np.ndarray) -> np.ndarray:
        return self._t[np.asarray(ids, dtype=np.int64).ravel()]


@dataclasses.dataclass
class SemStage:
    """One planned staging op: write ``rows`` into cache ``slots`` and point
    ``ids`` at them. The tensors already lie on the cache's device (the
    single host->device copy happened in ``plan``). A background stage on
    CUDA was copied on a side stream: ``event`` marks the copies' end, and
    ``host`` holds the pinned buffers they read from."""

    seq: int
    slots: torch.Tensor     # int64 [m]
    ids: torch.Tensor       # int64 [m]
    rows: torch.Tensor      # fp32 [m, dim]
    n_rows: int
    background: bool = False
    event: Optional[torch.cuda.Event] = None
    host: tuple = ()


def training_budget_rows(n_entities: int, batch_size: int, n_negatives: int) -> int:
    """The hot-set budget the reference's training launcher gives a cache
    (``src/repro/launch/train.py``): four steps' working sets (at most 3
    anchors a query, the positive and the negatives), at least one step's,
    at most every entity."""
    per_batch = batch_size * (4 + n_negatives)
    return max(min(n_entities, 4 * per_batch), min(n_entities, per_batch))


class SemanticCache:
    """Bounded device-resident hot set of H_sem rows + id->slot indirection.

    The device state is a pair of tensors the model registers as frozen
    params (``models/base.py::init_params(semantic_cache=...)``):
    ``sem_cache`` [budget_rows, d_l] fp32 and ``sem_slot`` [n_rows] int32, on
    ``device`` (``cuda`` unless given). Host-side metadata (which entity owns
    which slot, CLOCK ref bits) lives here and is only mutated under a lock
    inside ``plan``.

    Eviction is CLOCK (second-chance): hits set a ref bit; the sweep hand
    clears ref bits until it finds a cold slot. Slots holding rows of the
    batch being planned are pinned, so a batch never evicts its own rows.

    ``plan`` -> ``apply_to`` is an ordered handshake (``seq``): stages must be
    applied in plan order. ``reconcile()`` drops all residency if a planned
    stage was never applied (a pipeline closed with stages still queued).

    Under a mesh ``ctx`` the hot set is replicated, as the sharding rules pin
    ``sem_cache``/``sem_slot``: each rank holds the whole buffer on its device
    (``ctx.device`` unless ``device`` names one), and the trainer stages the
    ids of the whole global batch on every rank, so the ranks' hot sets stay
    identical with no collective.
    """

    def __init__(self, store, budget_rows: int, n_rows: Optional[int] = None,
                 name: str = "sem_cache", device=None, ctx=None):
        if isinstance(store, np.ndarray):
            store = _ArrayReader(store)
        if budget_rows < 1:
            raise ValueError("budget_rows must be >= 1")
        self.store = store
        self.budget_rows = int(budget_rows)
        self.n_rows = int(n_rows if n_rows is not None else store.n_rows)
        self.dim = int(store.dim)
        self.name = name
        if device is None and ctx is not None:
            device = ctx.device
        self.device = resolve_device(device)
        # Device state, handed to init_params and updated in place by apply_to.
        self.buffer = torch.zeros((self.budget_rows, self.dim),
                                  dtype=torch.float32, device=self.device)
        self.slot_map = torch.zeros((self.n_rows,), dtype=torch.int32,
                                    device=self.device)
        # Host metadata (source of truth for residency).
        self._slot_of = np.full(self.n_rows, -1, dtype=np.int32)
        self._owner = np.full(self.budget_rows, -1, dtype=np.int64)
        self._ref = np.zeros(self.budget_rows, dtype=bool)
        self._hand = 0
        self._lock = threading.Lock()
        self._planned_seq = 0
        self._applied_seq = 0
        self._metrics = get_registry().group("sem_cache", cache=name)
        self.hits = self._metrics.counter("hits")
        self.misses = self._metrics.counter("misses")
        self.evictions = self._metrics.counter("evictions")
        self.stages = self._metrics.counter("stages")
        self.stages_background = self._metrics.counter("stages_background")
        self.rows_staged = self._metrics.counter("rows_staged")
        self.bytes_staged = self._metrics.counter("bytes_staged")
        self.resident_gauge = self._metrics.gauge("resident_rows")

    # ------------------------------------------------------------- planning
    def plan(self, ent_ids, background: bool = False,
             stream=None) -> Optional[SemStage]:
        """Ensure every id in ``ent_ids`` is device-resident once the returned
        stage is applied: store reads, dequantize and the one host->device
        copy happen here. Returns None on a full hit.

        ``background=True`` counts the stage in ``stages_background`` (the
        training pipeline's scheduler thread plans every stage so). On a
        CUDA cache it then needs the scheduler thread's side ``stream``: the
        rows and the slot/id pairs go through pinned buffers and copy on it
        without blocking, and the stage carries an event that ``apply_to``
        waits on. Staged sets are not padded to a power of two (the JAX
        package pads them to close its scatter's jit signature set; eager
        PyTorch has none)."""
        on_cuda = self.device.type == "cuda"
        if background and on_cuda and stream is None:
            raise ValueError("a background stage on CUDA needs the side stream "
                             "it copies on")
        with self._lock:
            ids = np.unique(np.asarray(ent_ids, dtype=np.int64).ravel())
            if len(ids) and (ids[0] < 0 or ids[-1] >= self.n_rows):
                raise IndexError(f"entity ids out of range [0, {self.n_rows})")
            if len(ids) > self.budget_rows:
                raise RuntimeError(
                    f"batch needs {len(ids)} semantic rows but the cache "
                    f"budget is {self.budget_rows}; raise "
                    f"--semantic-budget-rows or shrink the batch")
            known = self._slot_of[ids]
            hit = known >= 0
            self.hits += int(hit.sum())
            self._ref[known[hit]] = True
            missing = ids[~hit]
            self.misses += len(missing)
            if len(missing) == 0:
                return None
            pinned = np.zeros(self.budget_rows, dtype=bool)
            pinned[known[hit]] = True
            slots = np.empty(len(missing), dtype=np.int64)
            for j, e in enumerate(missing):
                while True:  # CLOCK sweep; terminates: unpinned >= remaining
                    s = self._hand
                    self._hand = (self._hand + 1) % self.budget_rows
                    if pinned[s]:
                        continue
                    if self._ref[s]:
                        self._ref[s] = False
                        continue
                    break
                old = self._owner[s]
                if old >= 0:
                    self._slot_of[old] = -1
                    self.evictions += 1
                self._owner[s] = e
                self._slot_of[e] = s
                self._ref[s] = True
                pinned[s] = True
                slots[j] = s
            m = len(missing)
            self.stages += 1
            if background:
                self.stages_background += 1
            self.rows_staged += m
            self.bytes_staged += m * self.dim * 4
            self.resident_gauge.set(int((self._owner >= 0).sum()))
            self._planned_seq += 1
            seq = self._planned_seq
        # Store I/O and the device copy happen OUTSIDE the lock: the metadata
        # above is already consistent, and apply_to's seq check must never
        # wait out a disk read.
        with TRACER.span("store_io", rows=m):
            rows = self.store.read_rows(missing)  # host gather + dequantize
        if not (background and on_cuda):
            return SemStage(
                seq=seq,
                slots=torch.from_numpy(slots).to(self.device),
                ids=torch.from_numpy(missing).to(self.device),
                rows=torch.from_numpy(rows).to(self.device),
                n_rows=m,
                background=background,
            )
        (slots_d, ids_d), _, pairs = packed_to_device([slots, missing], self.device, stream)
        host_rows = torch.empty(rows.shape, dtype=torch.float32, pin_memory=True)
        host_rows.numpy()[...] = rows
        with torch.cuda.stream(stream):
            rows_d = host_rows.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return SemStage(seq=seq, slots=slots_d, ids=ids_d, rows=rows_d, n_rows=m,
                        background=True, event=event, host=(pairs, host_rows))

    # -------------------------------------------------------------- applying
    def apply_to(self, params: Dict, stage: SemStage) -> Dict:
        """Second half of the handshake: write the staged rows into
        ``params["sem_cache"]`` and their slots into ``params["sem_slot"]``,
        in place. The writes are enqueued on the current stream after every
        kernel of the batches already dispatched, which is why reusing their
        slots is safe (module docstring). A stage copied on a side stream is
        waited for on the current stream first, and its tensors are marked
        as used there, so the allocator does not hand their memory back to
        the side stream while these writes may still read it. Returns
        ``params``."""
        with self._lock:
            if stage.seq != self._applied_seq + 1:
                raise RuntimeError(
                    f"stage applied out of order (got seq {stage.seq}, "
                    f"expected {self._applied_seq + 1})")
            self._applied_seq = stage.seq
        if stage.event is not None:
            current = torch.cuda.current_stream(stage.rows.device)
            current.wait_event(stage.event)
            for t in (stage.slots, stage.ids, stage.rows):
                t.record_stream(current)
        slot_map = params["sem_slot"]
        params["sem_cache"].index_copy_(0, stage.slots, stage.rows)
        slot_map.index_copy_(0, stage.ids, stage.slots.to(slot_map.dtype))
        return params

    def reconcile(self) -> None:
        """If any planned stage was never applied, device state no longer
        matches the metadata — drop all residency so future plans restage
        from the store."""
        with self._lock:
            if self._planned_seq != self._applied_seq:
                self._reset_locked()

    def reset(self) -> None:
        """Drop all residency, so that the next plan restages every row it
        needs from the store (after the cache's tensors were overwritten, as
        a resumed checkpoint does)."""
        with self._lock:
            self._reset_locked()

    def _reset_locked(self) -> None:
        self._slot_of[:] = -1
        self._owner[:] = -1
        self._ref[:] = False
        self._hand = 0
        self._planned_seq = self._applied_seq = 0
        self.resident_gauge.set(0)

    # -------------------------------------------------------------- metrics
    @property
    def resident_rows(self) -> int:
        return int((self._owner >= 0).sum())

    @property
    def hit_rate(self) -> float:
        n = int(self.hits) + int(self.misses)
        return int(self.hits) / n if n else 0.0

    @property
    def prefetch_overlap_frac(self) -> float:
        """The share of stages planned in the background (off the step's
        critical path)."""
        n = int(self.stages)
        return int(self.stages_background) / n if n else 0.0

    @property
    def device_resident_sem_bytes(self) -> int:
        """Device bytes pinned by the semantic subsystem: the hot-set buffer
        + the id->slot indirection (independent of E x d_l)."""
        return self.budget_rows * self.dim * 4 + self.n_rows * 4

    def resident_ids(self) -> np.ndarray:
        return np.sort(self._owner[self._owner >= 0])

    def stats(self) -> Dict[str, float]:
        return {
            "name": self.name,
            "budget_rows": self.budget_rows,
            "resident_rows": self.resident_rows,
            "hits": int(self.hits),
            "misses": int(self.misses),
            "evictions": int(self.evictions),
            "hit_rate": self.hit_rate,
            "stages": int(self.stages),
            "stages_background": int(self.stages_background),
            "sync_stages": int(self.stages) - int(self.stages_background),
            "prefetch_overlap_frac": self.prefetch_overlap_frac,
            "rows_staged": int(self.rows_staged),
            "bytes_staged": int(self.bytes_staged),
            "device_resident_sem_bytes": self.device_resident_sem_bytes,
        }

    def reset_counters(self) -> None:
        """Zero counters (not residency) — e.g. after serving warm-up."""
        with self._lock:
            self._metrics.reset()
            self.resident_gauge.set(int((self._owner >= 0).sum()))
