"""Read the numbers that set a cell's check limits: the program's over many
seeds, and the control's on the same checked requests, in one process.

    python3 perfbench/calibrate.py --workload serve.betae.mix --seconds 3 --seeds 101 102 103

Each seed is one run of the cell at its own load (a short window, the same
warm-up, the same sample of answers checked) with the control beside it:
the plain reference with every matrix product in TF32, answering the same
requests as the program serves them. One JSON line a seed, then the largest
program reading and the smallest control reading of each number. The
benchmark's own runs never run the control.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# Kernels that PyTorch and the CUDA driver compile at run time are cached
# at fixed paths in the checkout, so only a checkout's first run compiles.
for _var, _dir in (("PYTORCH_KERNEL_CACHE_PATH", "torch-kernels"),
                   ("CUDA_CACHE_PATH", "cuda-cache"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch-extensions")):
    os.environ.setdefault(_var, str(ROOT / "build" / "perfbench" / _dir))
    os.makedirs(os.environ[_var], exist_ok=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench: calibration needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(ROOT, args.workload)
    worst, least = {}, {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t0,
                               cache_dir=ROOT / "build" / "perfbench", control=True)
        prog = {k: v["value"] for k, v in out["checks"].items()}
        line = {"workload": cell.name, "seed": seed, "correct": out["correct"],
                "program": prog, "control": out.get("control"),
                "serve_qps": out["metrics"].get("serve_qps", {}).get("value")}
        print(json.dumps(line), flush=True)
        for k, v in prog.items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in (out.get("control") or {}).items():
            least[k] = min(least.get(k, v), v)
    print(json.dumps({"workload": cell.name, "seeds": len(args.seeds),
                      "program_max": worst, "control_min": least,
                      "limits": cell.config["check_limits"],
                      "card": harness.card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
