"""Launch-environment tuning: the process-level knobs that must be set
BEFORE the interpreter starts to take effect.

The pipelined trainer's sampler, scheduler and dispatch threads all allocate
on the host, and an allocator preloaded with ``LD_PRELOAD`` only applies at
process start — so this lives here as a *launcher*, not a library call:

    python -m repro_torch.launch.env [--threads 4] -- \\
        python -m repro_torch.launch.train ...

builds the tuned environment and ``exec``s the command under it.

Knobs (each reported by ``--report`` / skipped gracefully when unavailable):

* **tcmalloc** — ``LD_PRELOAD`` of libtcmalloc: the glibc allocator's arena
  contention is measurable with the pipeline's sampler/scheduler/dispatch
  threads all allocating; also raises the large-alloc report threshold so
  multi-GB table mmaps don't spam stderr.
* **thread pins** — OMP/MKL/OPENBLAS thread caps so host BLAS doesn't
  oversubscribe the cores the pipeline's own thread lanes need.

* **autotune cache** — ``--autotune-cache PATH`` sets
  ``REPRO_TORCH_AUTOTUNE_CACHE`` for the child, which names the process
  tuner's persisted cache (``kernels/autotune.py``).

Everything else is additive to the caller's environment: a variable the
caller already set is NEVER overwritten (report says "kept"); the explicit
``--autotune-cache`` is set as given. The JAX package's launcher also sets
XLA flags and JAX dtype pins, which mean nothing to PyTorch.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shlex
import sys
from typing import Dict, List, Optional, Tuple

#: Common install locations for tcmalloc (gperftools / libtcmalloc-minimal).
TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
    "/usr/lib64/libtcmalloc.so.4",
)

#: Sentinel guarding against the launcher re-exec'ing under itself.
_SENTINEL = "REPRO_ENV_LAUNCHED"
#: ``kernels/autotune.py::ENV_CACHE``, named here so that this launcher
#: imports no torch (tests/test_torch_launch.py holds the two equal).
AUTOTUNE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"


def find_tcmalloc() -> Optional[str]:
    for p in TCMALLOC_CANDIDATES:
        if os.path.exists(p):
            return p
    return None


def tcmalloc_active() -> bool:
    """Whether tcmalloc is actually mapped into THIS process (LD_PRELOAD
    must have been set before exec — setting it now does nothing)."""
    try:
        with open("/proc/self/maps") as f:
            return "tcmalloc" in f.read()
    except OSError:
        return False


@dataclasses.dataclass
class EnvPlan:
    """The computed environment delta + human-readable notes per knob."""

    env: Dict[str, str]
    notes: List[Tuple[str, str]]  # (knob, what happened)

    def apply(self, base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        merged = dict(os.environ if base is None else base)
        merged.update(self.env)
        return merged

    def report(self) -> str:
        lines = ["launch-env plan:"]
        for knob, what in self.notes:
            lines.append(f"  {knob:<18} {what}")
        return "\n".join(lines)


def build_plan(threads: Optional[int] = None, tcmalloc: bool = True,
               base: Optional[Dict[str, str]] = None) -> EnvPlan:
    """Compute the environment delta for a tuned launch. Never overwrites a
    variable the caller already set (the note records it as kept)."""
    cur = dict(os.environ if base is None else base)
    env: Dict[str, str] = {}
    notes: List[Tuple[str, str]] = []

    def want(key: str, val: str, why: str) -> None:
        if key in cur:
            notes.append((key, f"kept caller value {cur[key]!r}"))
        else:
            env[key] = val
            notes.append((key, f"{val!r}  ({why})"))

    if tcmalloc:
        lib = find_tcmalloc()
        if lib:
            want("LD_PRELOAD", lib, "arena-contention-free allocator for "
                 "the pipeline's host threads")
            want("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", "60000000000",
                 "silence large-mmap reports for multi-GB tables")
        else:
            notes.append(("LD_PRELOAD", "skipped — no libtcmalloc found"))

    if threads is not None and threads > 0:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            want(var, str(threads),
                 "cap host BLAS so pipeline lanes keep their cores")

    return EnvPlan(env=env, notes=notes)


def current_report() -> Dict[str, object]:
    """What the CURRENT process actually launched with."""
    return {
        "tcmalloc_active": tcmalloc_active(),
        "tcmalloc_found": find_tcmalloc(),
        "ld_preload": os.environ.get("LD_PRELOAD", ""),
        "omp_num_threads": os.environ.get("OMP_NUM_THREADS", ""),
        "autotune_cache": os.environ.get(AUTOTUNE_ENV, ""),
        "launched_via_env": _SENTINEL in os.environ,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.env",
        description="Build a tuned launch environment and exec a command "
                    "under it: python -m repro_torch.launch.env [flags] -- cmd ...")
    ap.add_argument("--threads", type=int, default=None,
                    help="cap OMP/MKL/OpenBLAS threads")
    ap.add_argument("--no-tcmalloc", action="store_true")
    ap.add_argument("--autotune-cache", default=None,
                    help=f"set {AUTOTUNE_ENV} for the child (the persisted "
                         "kernel launch-geometry cache)")
    ap.add_argument("--report", action="store_true",
                    help="print the plan (and current-process state) and exit")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the plan + command without exec'ing")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to exec (prefix with --)")
    args = ap.parse_args(argv)

    plan = build_plan(threads=args.threads, tcmalloc=not args.no_tcmalloc)
    if args.autotune_cache:
        plan.env[AUTOTUNE_ENV] = args.autotune_cache
        plan.notes.append((AUTOTUNE_ENV, repr(args.autotune_cache)))

    if args.report:
        print(plan.report())
        for k, v in sorted(current_report().items()):
            print(f"  current: {k} = {v!r}")
        return 0

    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        print(plan.report())
        print("no command given — pass one after `--` (or use --report)",
              file=sys.stderr)
        return 2

    print(plan.report(), file=sys.stderr)
    if args.dry_run:
        print(f"would exec: {shlex.join(cmd)}", file=sys.stderr)
        return 0
    child_env = plan.apply()
    child_env[_SENTINEL] = "1"
    os.execvpe(cmd[0], cmd, child_env)
    return 0  # unreachable


if __name__ == "__main__":
    raise SystemExit(main())
