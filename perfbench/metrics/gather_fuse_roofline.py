"""The ``gather_fuse`` kernel's share of its roofline: the mean least time of
its calls in the traced window (from their shapes) over the mean time of
its launches on the card."""
from perfbench import counts

HOOK = "gather_fuse_params"


def _is_launch(name: str) -> bool:
    return "gather_fuse" in name and "kernel" in name and "backward" not in name


def _least(args):
    params, (ids, _) = args[0], args[1]
    n = 1
    for x in ids:
        n *= x
    if n == 0:      # no launch
        return None
    (_, d), elt = params["entity"]
    sem = params.get("sem_table") or params.get("sem_cache")
    dl, dp = sem[0][1], params["sem_proj_w"][0][1]
    return counts.least_seconds(*counts.gather_fuse(n, d, dl, dp, elt),
                                counts.PEAKS["tf32_flops_per_s"])


def read(run):
    return counts.roofline_pct(run, HOOK, _is_launch, _least)
