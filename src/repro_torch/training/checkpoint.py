"""Fault-tolerant checkpointing, in the JAX package's on-disk format.

  * atomic   — write to a temporary directory, fsync, rename; a crash
               mid-write never corrupts the latest checkpoint.
  * verified — a manifest with a SHA256 per array; load refuses silent
               bitrot and falls back to the previous valid checkpoint.
  * portable — ``arrays.npz`` holds host numpy arrays under slash-joined
               keys of the nested dict (``params/entity``, ``opt/m/entity``,
               ``opt/step``), the keys the reference's pytree paths give, so
               a checkpoint written by either package loads in the other.
  * mesh-agnostic — arrays are stored whole: under a mesh the trainer
               gathers them, rank 0 writes and the others wait; a restore
               reads the full arrays, checks each against its template's
               whole shape (entity rows may differ by mesh padding alone)
               and keeps the current mesh's shard of each
               (``load_checkpoint(ctx=)``), whatever mesh wrote them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(key, leaf) pairs of a nested dict in sorted-key order (the
    reference's pytree order)."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree, metadata: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"ckpt_{step:010d}"
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".{name}.tmp")
    manifest = {"step": step, "time": time.time(), "metadata": metadata or {}, "arrays": {}}
    arrays = {}
    for key, leaf in _flatten(tree):
        arr = _host(leaf)
        arrays[key] = arr
        manifest["arrays"][key] = {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    final = os.path.join(directory, name)
    if os.path.exists(final):  # same step already published (e.g. final save)
        shutil.rmtree(tmp, ignore_errors=True)
        return final
    os.rename(tmp, final)  # atomic publish
    return final


def _verify(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for key, info in manifest["arrays"].items():
                if hashlib.sha256(z[key].tobytes()).hexdigest() != info["sha256"]:
                    return False
        return True
    except Exception:
        return False


def list_checkpoints(directory: str) -> List[str]:
    if not os.path.isdir(directory):
        return []
    names = sorted(n for n in os.listdir(directory) if n.startswith("ckpt_"))
    return [os.path.join(directory, n) for n in names]


# Leaves whose rows are the graph's entities (a leaf is named by the nearest
# key that is not ``m`` or ``v``): their rows past the graph's entity count
# are padding to a multiple of the mesh size, so a checkpoint's row count
# may differ from the template's by padding alone.
ENTITY_ROW_NAMES = ("entity", "sem_table")


def _unflatten(template, arrays: Mapping[str, np.ndarray], ctx=None, shapes=None,
               n_entities: Optional[int] = None, prefix: str = "", name: str = ""):
    """``template``'s nested dict of tensors with each leaf replaced by the
    array of its key, as a tensor on that leaf's device and in its dtype —
    under a mesh ``ctx``, this rank's shard of it, by the name of the leaf
    (the nearest key that is not ``m`` or ``v``, so a moment is sharded like
    its parameter). A ``None`` leaf stays ``None``."""
    if template is None:
        return None
    if isinstance(template, Mapping):
        return {k: _unflatten(v, arrays, ctx, None if shapes is None else shapes.get(k),
                              n_entities, f"{prefix}{k}/", name if k in ("m", "v") else k)
                for k, v in template.items()}
    key = prefix[:-1]
    arr = arrays[key]
    sharded = ctx is not None and ctx.is_sharded
    want = tuple(shapes) if shapes is not None else (None if sharded else tuple(template.shape))
    ckpt_rows = None   # set where the checkpoint lacks padding rows
    if want is not None and tuple(arr.shape) != want:
        have = tuple(arr.shape)
        if not (name in ENTITY_ROW_NAMES and n_entities is not None
                and len(have) == len(want) >= 1 and have[1:] == want[1:]
                and want[0] >= n_entities):
            raise ValueError(f"checkpoint leaf {key!r} has shape {have}; the template "
                             f"wants {want}")
        if have[0] < n_entities:
            raise ValueError(f"checkpoint leaf {key!r} holds {have[0]} entity rows, fewer "
                             f"than the graph's {n_entities} entities")
        if have[0] > want[0]:
            arr = arr[:want[0]]        # surplus padding rows
        else:
            ckpt_rows = have[0]
            arr = np.concatenate([arr, np.zeros((want[0] - have[0],) + have[1:], arr.dtype)])
    full = torch.from_numpy(np.array(arr)).to(template.device, template.dtype)
    out = ctx.shard(name, full) if sharded else full
    if tuple(out.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {key!r} of shape {tuple(arr.shape)} gives this "
                         f"rank {tuple(out.shape)}; the template holds {tuple(template.shape)}")
    if ckpt_rows is not None:
        # Padding rows the checkpoint lacks keep the template's own values.
        axes = ctx.row_axes(name, want) if sharded else ()
        lo = ctx.mesh.index(axes) * out.shape[0] if axes else 0
        start = max(ckpt_rows - lo, 0)
        if start < out.shape[0]:
            out[start:] = template[start:]
    return out


def load_checkpoint(directory: str, template=None, ctx=None, shapes=None,
                    n_entities: Optional[int] = None):
    """Load the newest VALID checkpoint. Returns (step, tree, metadata) or
    None; ``tree`` is the flat {key: array} dict, or ``template``'s
    structure of tensors (each this rank's shard under a mesh ``ctx``; a
    ``None`` leaf stays ``None``, as the reference's pytree flattening
    leaves it).

    Every leaf is held to its template's whole shape — ``shapes``, a nested
    dict like ``template``'s, where the template's leaves are one rank's
    shards; the leaf's own shape otherwise — and a mismatch raises
    ``ValueError`` naming the key and both shapes. The one exception, given
    the graph's ``n_entities``, is the row count of an entity-row table
    (``ENTITY_ROW_NAMES``): rows past ``n_entities`` are padding and never
    scored, so surplus padding rows are dropped and missing ones keep the
    template's values (a checkpoint with fewer rows than ``n_entities``
    raises). Only then does ``ctx.shard`` cut this rank's block, so a
    checkpoint restores onto any mesh, whatever mesh (or padding) wrote it."""
    for path in reversed(list_checkpoints(directory)):
        if not _verify(path):
            continue  # corrupted (e.g. node died mid-write pre-rename) — skip
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if template is None:
            return manifest["step"], arrays, manifest["metadata"]
        tree = _unflatten(template, arrays, ctx, shapes, n_entities)
        return manifest["step"], tree, manifest["metadata"]
    return None


class CheckpointManager:
    """Rolling checkpoints + auto-resume, with retention policy."""

    def __init__(self, directory: str, keep: int = 3, every: int = 100):
        self.directory = directory
        self.keep = keep
        self.every = every

    def due(self, step: int, force: bool = False) -> bool:
        return force or (self.every > 0 and step % self.every == 0)

    def maybe_save(self, step: int, tree, metadata=None, force=False,
                   ctx=None) -> Optional[str]:
        """Save ``tree`` when ``step`` is due. Under a mesh ``ctx`` every rank
        calls this with the gathered (full) tree: rank 0 writes, and every
        rank waits at a barrier until it has."""
        if not self.due(step, force):
            return None
        sharded = ctx is not None and ctx.is_sharded
        path = None
        if not sharded or ctx.rank == 0:
            path = save_checkpoint(self.directory, step, tree, metadata)
            self._gc()
        if sharded:
            ctx.mesh.barrier()
        return path

    def _gc(self) -> None:
        for old in list_checkpoints(self.directory)[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    def restore(self, template=None, ctx=None, shapes=None, n_entities=None):
        return load_checkpoint(self.directory, template, ctx, shapes, n_entities)
