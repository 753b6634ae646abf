"""LiveNGDB: online KG writes with incremental embedding maintenance.

The write front door that turns the read-optimized serving stack into a
database: ``write`` validates and commits a triple burst into the
``KnowledgeGraph`` (atomic CSR publish, version bump, snapshot retention),
grows the entity table / on-disk ``SemanticStore`` when the burst introduces
unseen entities, and enqueues the written triples for BACKGROUND
fine-tuning on a maintenance thread — serving continues on the engine's
batcher, bounded by its ``max_staleness_versions``.

Division of labor per write:

  writer thread (synchronous, cheap)             maintenance thread (async)
  ---------------------------------------        --------------------------
  grow params entity rows (+ store append)       incremental_finetune on the
  kg.add_entities / kg.insert_triples            written triples (on clones:
  -> version bump, snapshot, listeners fire      the live params stay
  enqueue the receipt                            readable), then
  return WriteReceipt                            engine.update_params(new)

The fine-tune is a pure function of (params, triples, seed), so a
synchronous rerun from the same inputs reproduces the background thread's
output bitwise. On CUDA the maintenance thread launches on the default
stream, as the batcher does: its kernels interleave with the batcher's in
stream order, so the tensors ``update_params`` publishes are complete before
any later batch reads them.

New entity rows are drawn from a ``torch.Generator`` seeded from
``(seed, version)``: the JAX package folds the version into a JAX PRNG key,
whose bits torch cannot reproduce, so only the distribution and the
claim-the-padding-first rule are the reference's.

Under a mesh (the engine's ``ctx``) every rank builds the same ``LiveNGDB``
over its own copy of the graph and its shards. Rank 0 alone takes writes and
runs the maintenance thread; each write and each fine-tune holds the
engine's ``MeshLane`` for its whole duration (serving pauses meanwhile) and
is announced on it, so every rank commits the write, grows its tables,
fine-tunes (collective: ``incremental_finetune(ctx=)``) and publishes at the
same point of the lane's order; the other ranks do it in ``follow()``. A
growth re-blocks the entity table (and a resident ``sem_table``): every
block boundary moves, so the rows are gathered, appended to and cut again
(``reblock_bytes`` keeps what each growth gathered). A ``SemanticStore`` is
appended by rank 0 alone (the ranks share its directory), and the others
read the new rows once it has.
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WriteReceipt:
    """What one ``LiveNGDB.write`` actually did."""

    graph_version: int        # version the write committed at (or the
    #                           pre-existing version for a no-op write)
    n_written: int            # fresh triples inserted (post-dedup)
    n_new_entities: int       # entity ids added ahead of the triples
    fresh_triples: np.ndarray  # the deduped rows, [n_written, 3]


def _generator(seed: int, version: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from the pair ``(seed, version)``."""
    state = np.random.SeedSequence([seed, version]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def grow_entity_rows(model, params, n_new: int, *, seed: int = 0,
                     version: int = 0, sem_rows=None, ctx=None):
    """Append ``n_new`` entity rows to the params tables, returning new
    params (the input dict is not mutated; unchanged tensors are shared).

    New embeddings are N(0, 1/sqrt(d)) as ``init_params`` draws them, from a
    generator seeded by ``(seed, version)`` so every write burst gets
    distinct but reproducible rows. Rows already present as alignment
    padding (``cfg.entity_pad``) are claimed first — they were initialized
    the same way, so claiming one only widens the score mask.

    ``model.n_entities`` is advanced. A serving engine keeps the count
    beside each params snapshot it retains, so a version-pinned replay
    keeps the mask of its admitted state.

    ``sem_rows`` ([n_new, d_l] fp32) extends a full-resident ``sem_table``.
    The out-of-core hot-set layout (``sem_slot``/``sem_cache``) fixes its
    indirection size at construction — growing it live is not supported.

    Under a mesh ``ctx`` the params are this rank's shards and the call is
    collective: every rank draws the same new rows, and a table that gains
    rows is gathered, grown as single-device and cut to this rank's block of
    the new layout (every block boundary moves). ``model.full_shapes`` takes
    the new shapes. The rows must stay split over the same axes (the
    padding, ``cfg.entity_pad``, a multiple of their ways).
    """
    if n_new < 0:
        raise ValueError("n_new must be >= 0")
    if n_new == 0:
        return params
    if "sem_slot" in params:
        raise NotImplementedError(
            "live entity growth with the out-of-core semantic hot set is "
            "not supported (sem_slot indirection is fixed-size); rebuild "
            "the store offline instead")
    sharded = ctx is not None and ctx.is_sharded
    old_n = model.n_entities
    new_n = old_n + int(n_new)
    entity = params["entity"]
    d = int(entity.shape[1])
    new_rows = model.padded_entities(new_n)
    axes = ctx.row_axes("entity", model.full_shapes["entity"]) if sharded else ()
    rows = int(entity.shape[0]) * (ctx.mesh.ways(axes) if sharded else 1)
    if sharded and new_rows > rows and ctx.row_axes("entity", (new_rows, d)) != axes:
        raise NotImplementedError(
            f"growing the entity table to {new_rows} rows would change the axes its "
            f"rows are split over ({axes} under {ctx.describe()}); pad the entity rows "
            "(ModelConfig.entity_pad) to a multiple of the mesh size")
    sem_width = None
    if "sem_table" in params:
        sem_width = int(model.full_shapes["sem_table"][1]) if sharded else int(
            params["sem_table"].shape[1])
        if sem_rows is None:
            raise ValueError(
                "params carry a sem_table: pass sem_rows ([n_new, d_l]) "
                "for the new entities")
        if tuple(np.shape(sem_rows)) != (n_new, sem_width):
            raise ValueError(
                f"sem_rows shape {tuple(np.shape(sem_rows))} != ({n_new}, {sem_width})")

    def whole(name, local, shape):
        return ctx.gather(name, local, shape) if sharded else local

    def cut(name, full):
        return ctx.shard(name, full) if sharded else full

    params = dict(params)
    final_rows = max(rows, new_rows)
    if new_rows > rows:
        gen = _generator(seed, version, entity.device)
        extra = torch.randn((new_rows - rows, d), generator=gen,
                            device=entity.device) * (1.0 / math.sqrt(d))
        full = whole("entity", entity, (rows, d))
        params["entity"] = cut("entity", torch.cat([full, extra.to(full.dtype)]))
    if sem_width is not None:
        table = whole("sem_table", params["sem_table"], (rows, sem_width))
        sem_rows = torch.as_tensor(np.asarray(sem_rows)).to(table.device, table.dtype)
        # The stored table is padded to the entity-row count; place the new
        # semantic rows at their entity ids and re-pad to the new row count.
        st = torch.cat([table[:old_n], sem_rows])
        if final_rows > new_n:
            st = torch.cat([st, st.new_zeros((final_rows - new_n, st.shape[1]))])
        params["sem_table"] = cut("sem_table", st)
    model.n_entities = new_n
    model.full_shapes = {**getattr(model, "full_shapes", {}), "entity": (final_rows, d)}
    if sem_width is not None:
        model.full_shapes["sem_table"] = (final_rows, sem_width)
    return params


class LiveNGDB:
    """Write coordinator binding a ``KnowledgeGraph``, a ``ServingEngine``
    and (optionally) a ``SemanticStore`` into a live database.

    One daemon maintenance thread consumes committed writes in order and
    publishes fine-tuned params through the engine's swap — the same path
    ``update_params`` takes, so every staleness/invalidation contract
    (mat-cache bumps, version-pinned params retention) holds. ``flush()``
    waits for the queue and re-raises the first background error.

    Under a mesh (module docstring) build one on every rank, over that
    rank's graph and engine; rank 0 writes and flushes, the others follow
    (``engine.follow()``) and raise on ``write``. Close it on rank 0 before
    the engine: a fine-tune announced after the engine closed has no
    followers."""

    def __init__(self, model, kg, engine, store=None, *,
                 finetune_steps: int = 4, finetune_lr: float = 1e-3,
                 n_negatives: int = 8, seed: int = 0):
        self.model = model
        self.kg = kg
        self.engine = engine
        self.store = store
        self.finetune_steps = finetune_steps
        self.finetune_lr = finetune_lr
        self.n_negatives = n_negatives
        self.seed = seed
        self.finetunes_done = 0
        # Wall seconds of each background fine-tune, its publish included.
        self.finetune_s: List[float] = []
        self.receipts: List[WriteReceipt] = []
        # Under a mesh: bytes each growth's re-block gathered on this rank.
        self.reblock_bytes: List[int] = []
        self._lane = engine._lane
        self.leader = engine.leader
        # A follower's receipts awaiting their fine-tune, by graph version.
        self._receipt_at: Dict[int, WriteReceipt] = {}
        self._errors: List[BaseException] = []
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        engine._live = self
        self._thread = None
        if self.leader:
            self._thread = threading.Thread(target=self._maintain, daemon=True,
                                            name="live-maintenance")
            self._thread.start()

    # -------------------------------------------------------------- writes
    def write(self, triples, n_new_entities: int = 0,
              sem_rows=None) -> WriteReceipt:
        """Commit one write burst. ``triples`` may reference the
        ``n_new_entities`` ids immediately above the current entity count;
        params (and the semantic store, if attached) grow FIRST so the ids
        are valid everywhere before the graph commit makes them reachable.

        Returns once the write is in the graph; the embedding fine-tune
        happens in the background (``flush()`` to wait). A burst that adds
        entities first waits for the fine-tunes already enqueued, so the
        tables grow from the newest params. A no-op burst (all duplicates)
        changes nothing and enqueues nothing. Under a mesh the write is
        checked, then announced on the lane and done on every rank."""
        if not self.leader:
            raise RuntimeError(f"rank {self.engine.ctx.rank} of "
                               f"{self.engine.ctx.describe()} takes no writes: write on "
                               "rank 0")
        if n_new_entities:
            # Grow the newest params: a fine-tune still queued or running
            # would otherwise publish a table without the new rows over the
            # grown one. No lock is held here: the fine-tunes need the lane.
            self.flush()
            # Refuse before anything grows: a write that raises changes
            # nothing (model.n_entities included).
            if self.store is not None and sem_rows is None:
                raise ValueError(
                    "a SemanticStore is attached: pass sem_rows for the "
                    "new entities")
        if self._lane is None:
            receipt = self._apply_write(triples, n_new_entities, sem_rows)
        else:
            triples = self._checked(triples, n_new_entities, sem_rows)
            with self._lane.held("write"):
                self._lane.announce("write", self.engine._lane_id,
                                    (triples, int(n_new_entities), sem_rows))
                receipt = self._apply_write(triples, n_new_entities, sem_rows)
        if len(receipt.fresh_triples):
            self._q.put(receipt)
        return receipt

    def _checked(self, triples, n_new: int, sem_rows) -> np.ndarray:
        """Under a mesh, rank 0 refuses a write before announcing it, so that
        nothing a write can raise on its inputs is met on a follower."""
        triples = np.asarray(triples, dtype=np.int64).reshape(-1, 3)
        if n_new < 0:
            raise ValueError("n_new_entities must be >= 0")
        if n_new and "sem_slot" in self.engine.params:
            raise NotImplementedError(
                "live entity growth with the out-of-core semantic hot set is "
                "not supported (sem_slot indirection is fixed-size)")
        if n_new and "sem_table" in self.engine.params:
            width = self.model.full_shapes["sem_table"][1]
            if sem_rows is None or tuple(np.shape(sem_rows)) != (n_new, width):
                raise ValueError(f"params carry a sem_table: pass sem_rows of shape "
                                 f"({n_new}, {width})")
        if len(triples):
            ents = triples[:, [0, 2]]
            if ents.min() < 0 or ents.max() >= self.kg.n_entities + n_new:
                raise ValueError("entity id out of range")
            if triples[:, 1].min() < 0 or triples[:, 1].max() >= self.kg.n_relations:
                raise ValueError("relation id out of range")
        return triples

    def _apply_write(self, triples, n_new: int, sem_rows) -> WriteReceipt:
        """The write itself, on this rank (under a mesh at the write's point
        of the lane's order, on every rank)."""
        mesh = self.engine.ctx.mesh
        if n_new:
            version = self.kg.graph_version
            table_rows = (sem_rows if "sem_table" in self.engine.params
                          else None)
            b0 = sum(mesh.bytes.values()) if mesh is not None else 0
            params = grow_entity_rows(
                self.model, self.engine.params, n_new,
                seed=self.seed, version=version, sem_rows=table_rows,
                ctx=self.engine.ctx)
            if mesh is not None:
                self.reblock_bytes.append(sum(mesh.bytes.values()) - b0)
            if self.store is not None:
                if self.leader:
                    self.store.append_rows(np.asarray(sem_rows, np.float32))
                if mesh is not None:
                    mesh.barrier()   # rank 0 has appended: the others read
                    if not self.leader:
                        self.store.reload()
            self.kg.add_entities(n_new)
            if self.engine._mesh is not None:
                self.engine._mesh.reset()
            # Publish the grown tables through the engine's own swap path
            # so the params/mat-version pairing stays consistent.
            self.engine._swap(params)
        fresh = self.kg.insert_triples(triples)
        receipt = WriteReceipt(self.kg.graph_version, len(fresh),
                               int(n_new), fresh)
        self.receipts.append(receipt)
        if not self.leader and len(fresh):
            self._receipt_at[receipt.graph_version] = receipt
        return receipt

    # --------------------------------------------------------- maintenance
    def _finetune(self, receipt: WriteReceipt, seed: int) -> None:
        """Fine-tune on ``receipt``'s triples from the engine's current
        params and publish the result (collective under a mesh)."""
        from repro_torch.training.loop import incremental_finetune

        t0 = time.perf_counter()
        params, _ = incremental_finetune(
            self.model, self.engine.params, receipt.fresh_triples,
            steps=self.finetune_steps, lr=self.finetune_lr,
            n_negatives=self.n_negatives, seed=seed, ctx=self.engine.ctx)
        self.engine._swap(params)
        self.finetune_s.append(time.perf_counter() - t0)
        self.finetunes_done += 1

    def _follow_finetune(self, version: int, seed: int) -> None:
        self._finetune(self._receipt_at.pop(version), seed)

    def _maintain(self) -> None:
        while not self._stop.is_set():
            try:
                receipt = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                seed = self.seed + receipt.graph_version
                if self._lane is None:
                    self._finetune(receipt, seed)
                else:
                    # The whole fine-tune holds the lane: serving pauses.
                    with self._lane.held("finetune"):
                        self._lane.announce("finetune", self.engine._lane_id,
                                            (receipt.graph_version, seed))
                        self._finetune(receipt, seed)
            except BaseException as e:  # surfaced by flush()/close()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def flush(self, timeout: float = 60.0) -> None:
        """Block until every enqueued fine-tune has been applied, then
        re-raise the first background error (if any)."""
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)
        if self._q.unfinished_tasks:
            raise TimeoutError("live maintenance queue did not drain")
        if self._errors:
            raise self._errors[0]

    def close(self, flush: bool = True) -> None:
        try:
            if flush and not self._errors:
                self.flush()
        finally:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=5.0)

    def __enter__(self) -> "LiveNGDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close(flush=exc[0] is None)
