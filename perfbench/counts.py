"""The yardstick's table of peaks and its count of each kernel's work.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at its 700 W limit
(dense, no sparsity). A kernel's least time is the larger of its bytes over
the memory bandwidth and its FLOPs over the peak of its route, counted from
the shapes of one call: each input byte read once, each output byte written
once, a multiply-add as two FLOPs. Both kernels below run their products on
the tensor cores in 3xTF32, so their route's peak is TF32's.
"""
from __future__ import annotations

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "tf32_flops_per_s": 495e12,
}


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / peak_flops)


def intersect(n: int, k: int, d: int, hd: int, elt: int = 4):
    """Attention intersection of n rows of k inputs of width d, MLP d -> hd
    -> 1: (flops, bytes). Reads x and the MLP's weights, writes n rows."""
    flops = n * k * (2 * d * hd + 2 * hd) + n * k * 2 * d
    nbytes = (n * k * d + n * d) * elt + (d * hd + 2 * hd + 1) * 4
    return flops, nbytes


def gather_fuse(n: int, d: int, dl: int, dp: int, elt: int = 4, id_bytes: int = 8):
    """Fusion of n entities (Eq. 12): (flops, bytes). Reads each row's id,
    structural row and semantic row and the four weights, writes n rows."""
    flops = n * (2 * dl * dp + 2 * (d + dp) * d)
    nbytes = (n * (id_bytes + d * elt + dl * 4 + d * elt)
              + (dl * dp + dp + (d + dp) * d + d) * 4)
    return flops, nbytes


def roofline_pct(run, hook: str, is_launch, least_of_call) -> "float | None":
    """A kernel's share of its roofline in a traced run: the mean least time
    of the calls to ``hook`` (``least_of_call(args)``, None for a call that
    launches nothing) over the mean time of the device ops ``is_launch``
    picks by name. None where the window launched the kernel nowhere.

    One call is one launch. A count of launches that differs from the
    count of calls recorded means the program reached the kernel another
    way than the hooked entry, so the shares would be read from other
    calls than those timed: that raises, rather than leave the metric out.
    """
    if run.trace is None:
        return None
    launches, seconds = 0, 0.0
    for name, (n, s) in run.trace.by_name().items():
        if is_launch(name):
            launches += n
            seconds += s
    least = [t for t in (least_of_call(args) for args, _ in run.calls.get(hook, []))
             if t is not None]
    if launches != len(least):
        raise RuntimeError(f"{hook}: {launches} launches on the card against "
                           f"{len(least)} calls recorded at the hooked entry")
    if not launches:
        return None
    return 100.0 * (sum(least) / len(least)) / (seconds / launches)
