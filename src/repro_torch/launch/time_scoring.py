"""Times this checkout's ``scoring`` kernel against another version of it,
in one process on one card.

    PYTHONPATH=src python -m repro_torch.launch.time_scoring --baseline DIR

DIR is the root of another checkout of the repository (for example a
``git archive`` of the parent commit, unpacked): its
``src/repro_torch/kernels/csrc`` is compiled into a library of its own, and
its ``repro_scoring`` (the same C interface) is called on the same tensors.
At each shape (fp32, d = 400: the all-entity batch of 16, one query, a
4,096-row store chunk) and mode, the two kernels are timed in the order
baseline, this, this, baseline, with ``chip_smoke.py``'s protocol
(``kernels.timing.time_ms``: CUDA events, 512 MB flush zeroed before each
run, median of 25); this checkout's kernel is also timed with each of its
tilings forced. Both kernels' scores are held to the plain version first.
Prints the card's name and power limit, one line per shape, and one JSON
line with every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scoring import (DTYPES, MODES, TILES, scoring,
                                         scoring_ref, scoring_tile)
from repro_torch.kernels.timing import flush_buffer, time_ms

SHAPES = ((16, 14_951, 400), (1, 14_951, 400), (16, 4_096, 400))


def load_baseline(root: Path) -> ctypes.CDLL:
    """The other checkout's kernel library, built from its sources."""
    lib = ctypes.CDLL(str(build.build_library(root / "src" / "repro_torch" / "kernels" / "csrc")))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.repro_scoring.argtypes = [p, p, p, i, i, i, f, i, i, p]
    lib.repro_scoring.restype = i
    lib.repro_error_string.argtypes = [i]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def baseline_scoring(lib, q, e, gamma, mode):
    out = torch.empty((q.shape[0], e.shape[0]), dtype=torch.float32, device=q.device)
    err = lib.repro_scoring(q.data_ptr(), e.data_ptr(), out.data_ptr(), q.shape[0],
                            e.shape[0], q.shape[1], float(gamma), MODES[mode],
                            DTYPES[q.dtype], build.stream_handle(q))
    build.check(lib, err, "baseline scoring")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the checkout whose kernel is timed against this one")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_scoring: needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    base = load_baseline(args.baseline.resolve())
    build.load_library()
    flush = flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for B, N, d in SHAPES:
        q = torch.randn((B, d), generator=gen, device=dev)
        e = torch.randn((N, d), generator=gen, device=dev)
        for mode in ("dot", "l1"):
            want = scoring_ref(q, e, 12.0, mode)
            for name, got in (("baseline", baseline_scoring(base, q, e, 12.0, mode)),
                              ("this", scoring(q, e, 12.0, mode))):
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * d,
                                           msg=lambda m: f"{name} {mode} {(B, N, d)}: {m}")
            t_base = lambda: baseline_scoring(base, q, e, 12.0, mode)  # noqa: E731
            t_this = lambda: scoring(q, e, 12.0, mode)  # noqa: E731
            order = [("baseline", t_base), ("this", t_this), ("this", t_this),
                     ("baseline", t_base)]
            times = {"baseline": [], "this": []}
            for name, fn in order:
                times[name].append(time_ms(fn, flush, args.reps))
            by_tile = {str(t): time_ms(lambda: scoring(q, e, 12.0, mode, tile=t),  # noqa: B023
                                       flush, args.reps) for t in TILES}
            row = {"mode": mode, "B": B, "N": N, "d": d, "dtype": "float32",
                   "baseline_ms": times["baseline"], "ms": times["this"],
                   "tile": scoring_tile(e), "ms_by_tile": by_tile}
            rows.append(row)
            print(f"scoring[{mode}] {(B, N, d)}: baseline {times['baseline']} ms, "
                  f"this {times['this']} ms, by tile {by_tile} (the kernel takes "
                  f"{row['tile']})")
    print(json.dumps({"card": card, "scoring": rows}))


if __name__ == "__main__":
    main()
