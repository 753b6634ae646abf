"""Device time of one kernel call, as ``chip_smoke.py`` and
``launch/time_kernels.py`` measure it, the floor for reading a table that
such a time is held against, and the inputs both time ``intersect`` and
the ``gather_fuse`` backward on."""
from __future__ import annotations

import statistics

import torch

from repro_torch.kernels import build
from repro_torch.models.base import glorot

FLUSH_BYTES = 512 * 2**20  # ten times the H100's 50 MB L2


def flush_buffer(device) -> torch.Tensor:
    return torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)


def time_ms(fn, flush: torch.Tensor, reps: int = 25, clean: bool = False) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), with
    the L2 cache flushed before each run by zeroing ``flush``. Zeroing takes
    the card longer than the host needs to enqueue a run, so the card never
    waits on the host between the events and the host's launch cost stays
    out of the time.

    Zeroing leaves L2 full of dirty lines, which the run's own reads must
    write back to memory as they evict them. ``clean=True`` flushes by
    reading the buffer instead, which leaves L2 clean: a reading of what that
    write-back costs, not the protocol the reported times use."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def stream_read(t: torch.Tensor) -> torch.Tensor:
    """Per-SM partial sums of ``t`` (fp32, contiguous, on the card, 16-byte
    aligned, a multiple of 4 elements) by ``csrc/stream_read.cu``, a kernel
    that reads each byte once and does nothing else. Timed under
    ``time_ms``, it is the floor for a kernel that streams the same bytes; on
    an empty tensor it is the launch alone."""
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError("stream_read: needs a contiguous fp32 CUDA tensor")
    if t.numel() % 4 or (t.numel() and t.data_ptr() % 16):
        raise ValueError("stream_read: needs a 16-byte aligned tensor of 4k elements")
    lib = build.load_library()
    blocks = torch.cuda.get_device_properties(t.device).multi_processor_count
    part = torch.empty(blocks, dtype=torch.float32, device=t.device)
    with torch.cuda.device(t.device):
        err = lib.repro_stream_read(t.data_ptr(), t.numel() // 4, part.data_ptr(), blocks,
                                    build.stream_handle(t))
    build.check(lib, err, "stream_read")
    return part


def intersect_inputs(n: int, k: int, d: int, hd: int, dtype: torch.dtype,
                     generator: torch.Generator):
    """BetaE-like arguments of ``intersect`` on the generator's device:
    x [n, k, d] positive Beta parameters (as the entity-state map gives
    them), the attention MLP from the model's own initializer."""
    dev = generator.device
    x = torch.nn.functional.softplus(
        torch.randn((n, k, d), generator=generator, device=dev) / 10) + 0.05
    w1 = glorot((d, hd), generator, dev)
    b1 = 0.1 * torch.randn((hd,), generator=generator, device=dev)
    w2 = glorot((hd, 1), generator, dev)
    return x.to(dtype), w1, b1, w2, torch.zeros((1,), device=dev)


def fuse_backward_inputs(n: int, layout: str, E: int, d: int, dl: int, dp: int,
                         generator: torch.Generator):
    """A ``gather_fuse`` backward's inputs as training gives them, on the
    generator's device: ids drawn from min(E, n/2) entities (each about
    twice, as the loss's candidates repeat), H_sem resident or (``cache``)
    through a hot set of E rows at shuffled slots, g, and what training's
    forward saves: its output and zp (``gather_fuse_and_zp``). Returns (args,
    g, sem_ids, out, zp), args being ``gather_fuse``'s first seven."""
    from repro_torch.kernels.gather_fuse import gather_fuse_and_zp

    dev = generator.device
    h_str = torch.randn((E, d), generator=generator, device=dev) / d ** 0.5
    table = torch.nn.functional.normalize(
        torch.randn((E, dl), generator=generator, device=dev), dim=1)
    wp, wf = glorot((dl, dp), generator, dev), glorot((d + dp, d), generator, dev)
    bp = 0.1 * torch.randn((dp,), generator=generator, device=dev)
    bf = 0.1 * torch.randn((d,), generator=generator, device=dev)
    ids = torch.randint(0, min(E, max(n // 2, 1)), (n,), generator=generator, device=dev)
    h_sem, sem_ids = table, None
    if layout == "cache":
        slot_of = torch.randperm(E, generator=generator, device=dev)
        h_sem = torch.empty_like(table)
        h_sem[slot_of] = table
        sem_ids = slot_of[ids]
    g = torch.randn((n, d), generator=generator, device=dev)
    args = (ids, h_str, h_sem, wp, bp, wf, bf)
    return (args, g, sem_ids, *gather_fuse_and_zp(*args, sem_ids=sem_ids))
