"""Builds the port's CUDA kernels and loads them with ``ctypes``.

The sources in ``csrc/`` have a plain C interface, so ``nvcc`` compiles them
in seconds (no PyTorch headers): one ``nvcc`` per source, all started
together, then one link into a shared library. The library is built
at first use into ``build/repro_torch_kernels/`` at the repository root, keyed
by a hash of the sources and flags: a changed source builds a new library, an
unchanged one is reused. There is no fallback: on a machine without CUDA or
without ``nvcc`` loading raises, and the wrappers never quietly take their
plain versions for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently; raise with the compiler's output if
    any of them failed."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
             for c in cmds]
    # communicate() before returncode: it waits for the process to exit.
    done = [(c, *p.communicate(), p.returncode) for c, p in procs]
    for cmd, out, err, rc in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}{err}")


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the hashed shared library unless it is
    already built. Objects and the library are made in a private temporary
    directory and the library is renamed into place, so concurrent builders
    never see a half-written file."""
    path = library_path()
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources() if src.suffix == ".cu"]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(SRC_DIR / f"{o.stem}.cu"), "-o", str(o)]
                  for o in objs])
        lib = Path(tmp) / path.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, path)
    return path


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Raises when CUDA is
    not available."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA is not available: the hand-written kernels run only "
                    "on a GPU (CPU tensors take the plain PyTorch versions)")
            lib = ctypes.CDLL(str(build_library()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.repro_scoring.argtypes = [p, p, p, i, i, i, f, i, i, p]
            lib.repro_scoring.restype = i
            lib.repro_intersect.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
            lib.repro_intersect.restype = i
            lib.repro_intersect_tiles.argtypes = [i]
            lib.repro_intersect_tiles.restype = i
            lib.repro_error_string.argtypes = [i]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream
