"""The ``intersect`` kernel's share of its roofline: the mean least time of
its calls in the traced window (from their shapes) over the mean time of
its launches on the card."""
from perfbench import counts

HOOK = "intersect"


def _least(args):
    (n, k, d), elt = args[0]
    hd = args[1][0][1]
    if n == 0:      # no launch
        return None
    return counts.least_seconds(*counts.intersect(n, k, d, hd, elt),
                                counts.PEAKS["tf32_flops_per_s"])


def read(run):
    return counts.roofline_pct(run, HOOK, lambda name: "intersect_kernel" in name, _least)
