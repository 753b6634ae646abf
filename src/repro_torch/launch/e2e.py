"""End-to-end driver: train an NGDB on a larger synthetic graph with
semantics, adaptive sampling and checkpoints, simulate a mid-run crash,
resume, finish training, evaluate, then serve batched mixed-pattern
queries on the trained model — the port's twin of
``examples/e2e_train_serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.e2e [--steps 120] [--device cpu]

Runs on ``cuda`` unless ``--device`` names another device. Checkpoints go to
a temporary directory of its own, removed at the end.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Dict, Optional, Sequence

from repro_torch.data import load_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve_batch
from repro_torch.models import ModelConfig, make_model
from repro_torch.sampling import OnlineSampler
from repro_torch.semantic import PTEConfig, StubPTE, precompute_semantic_table
from repro_torch.training import AdamConfig, NGDBTrainer, TrainConfig, evaluate


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--dim", type=int, default=48)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ckpt_dir = tempfile.mkdtemp(prefix="ngdb_zoo_e2e_ckpt_")
    try:
        kg, full_kg, _ = load_dataset("ogbl-wikikg2")  # reduced stand-in
        print(f"graph: {kg.n_entities} entities, {len(kg)} triples")
        pte = StubPTE(PTEConfig(d_l=128, n_layers=2, d_model=64), device=device)
        table = precompute_semantic_table(kg, pte)
        print(f"semantic table {table.shape}; PTE unloaded={pte.unloaded}")

        model = make_model("betae", ModelConfig(dim=args.dim, semantic_dim=128),
                           device=device)
        cfg = TrainConfig(batch_size=args.batch_size, n_negatives=16,
                          adam=AdamConfig(lr=2e-3), adaptive=True,
                          checkpoint_dir=ckpt_dir, checkpoint_every=20)

        # phase 1: train halfway, then "crash"
        tr = NGDBTrainer(model, kg, cfg, semantic_table=table)
        half = args.steps // 2
        t0 = time.time()
        tr.train(half, log_every=20)
        print(f"--- simulated failure at step {tr.step} "
              f"({half * args.batch_size / (time.time() - t0):.0f} q/s) ---")
        del tr

        # phase 2: a fresh trainer resumes from the newest valid checkpoint
        tr = NGDBTrainer(model, kg, cfg, semantic_table=table)
        if not tr.resume():
            raise SystemExit(f"no checkpoint found in {ckpt_dir}")
        print(f"resumed at step {tr.step}; continuing")
        tr.train(args.steps - tr.step, log_every=20)

        qs = [b.query for b in OnlineSampler(kg, seed=5).sample_batch(32)]
        metrics = evaluate(model, tr.params, tr.executor, full_kg, qs, train_kg=kg)
        print("eval:", {k: round(float(v), 4) for k, v in metrics.items() if "/" not in k})

        # phase 3: serve batched requests on the trained model
        queries = [b.query for b in OnlineSampler(kg, seed=9).sample_batch(16)]
        results, _ = serve_batch(model, tr.params, tr.executor, queries, top_k=5,
                                 device=device)
        print("serve sample:", results[0])
        return {"step": tr.step, "metrics": metrics, "results": results}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
