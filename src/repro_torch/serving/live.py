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
"""
from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time
from typing import List

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
                     version: int = 0, sem_rows=None):
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
    old_n = model.n_entities
    new_n = old_n + int(n_new)
    entity = params["entity"]
    rows = int(entity.shape[0])
    new_rows = model.padded_entities(new_n)
    params = dict(params)
    if new_rows > rows:
        d = int(entity.shape[1])
        gen = _generator(seed, version, entity.device)
        extra = torch.randn((new_rows - rows, d), generator=gen,
                            device=entity.device) * (1.0 / math.sqrt(d))
        params["entity"] = torch.cat([entity, extra.to(entity.dtype)])
    if "sem_table" in params:
        table = params["sem_table"]
        if sem_rows is None:
            raise ValueError(
                "params carry a sem_table: pass sem_rows ([n_new, d_l]) "
                "for the new entities")
        sem_rows = torch.as_tensor(np.asarray(sem_rows)).to(table.device, table.dtype)
        if tuple(sem_rows.shape) != (n_new, table.shape[1]):
            raise ValueError(
                f"sem_rows shape {tuple(sem_rows.shape)} != "
                f"({n_new}, {table.shape[1]})")
        # The stored table is padded to the entity-row count; place the new
        # semantic rows at their entity ids and re-pad to the new row count.
        st = torch.cat([table[:old_n], sem_rows])
        if new_rows > new_n:
            st = torch.cat([st, st.new_zeros((new_rows - new_n, st.shape[1]))])
        params["sem_table"] = st
    model.n_entities = new_n
    return params


class LiveNGDB:
    """Write coordinator binding a ``KnowledgeGraph``, a ``ServingEngine``
    and (optionally) a ``SemanticStore`` into a live database.

    One daemon maintenance thread consumes committed writes in order and
    publishes fine-tuned params through ``engine.update_params`` — the same
    path online training uses, so every staleness/invalidation contract
    (mat-cache bumps, version-pinned params retention) holds. ``flush()``
    waits for the queue and re-raises the first background error.
    """

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
        # Wall seconds of each background fine-tune, update_params included.
        self.finetune_s: List[float] = []
        self.receipts: List[WriteReceipt] = []
        self._errors: List[BaseException] = []
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
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
        changes nothing and enqueues nothing."""
        if n_new_entities:
            # Grow the newest params: a fine-tune still queued or running
            # would otherwise publish a table without the new rows over the
            # grown one.
            self.flush()
            # Refuse before anything grows: a write that raises changes
            # nothing (model.n_entities included).
            if self.store is not None and sem_rows is None:
                raise ValueError(
                    "a SemanticStore is attached: pass sem_rows for the "
                    "new entities")
            version = self.kg.graph_version
            table_rows = (sem_rows if "sem_table" in self.engine.params
                          else None)
            params = grow_entity_rows(
                self.model, self.engine.params, n_new_entities,
                seed=self.seed, version=version, sem_rows=table_rows)
            if self.store is not None:
                self.store.append_rows(np.asarray(sem_rows, np.float32))
            self.kg.add_entities(n_new_entities)
            # Publish the grown tables through the engine's own swap path
            # so the params/mat-version pairing stays consistent.
            self.engine.update_params(params)
        fresh = self.kg.insert_triples(triples)
        receipt = WriteReceipt(self.kg.graph_version, len(fresh),
                               int(n_new_entities), fresh)
        self.receipts.append(receipt)
        if len(fresh):
            self._q.put(receipt)
        return receipt

    # --------------------------------------------------------- maintenance
    def _maintain(self) -> None:
        from repro_torch.training.loop import incremental_finetune

        while not self._stop.is_set():
            try:
                receipt = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                t0 = time.perf_counter()
                params, _ = incremental_finetune(
                    self.model, self.engine.params, receipt.fresh_triples,
                    steps=self.finetune_steps, lr=self.finetune_lr,
                    n_negatives=self.n_negatives,
                    seed=self.seed + receipt.graph_version)
                self.engine.update_params(params)
                self.finetune_s.append(time.perf_counter() - t0)
                self.finetunes_done += 1
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
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "LiveNGDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close(flush=exc[0] is None)
