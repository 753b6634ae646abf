"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 perfbench/run.py --workload serve.betae.mix --seed 7 --seconds 10 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the program (``src/repro_torch``). It needs as many CUDA devices as the
cell asks for, and exits with a non-zero code and prints no result
without them, without the program, when an answer is wrong to the point
of not being checkable, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: cell {cell.name} needs {need} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                           T_START, cache_dir=ROOT / "build" / "perfbench")
    if args.trace:
        out["card"] = harness.card()
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: loaded {found}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    checks = out.pop("checks")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    sys.stdout.flush()
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
