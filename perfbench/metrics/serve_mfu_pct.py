"""The whole serving step's share of the card's peak: the FLOPs that the
requests answered in the traced window need (counted per query from shapes
by the configuration's model family, ``query_flops``, with no padding
rows), over the window's seconds, against the card's TF32 peak. It bounds
the kernels' roofline shares: a kernel taken off the path leaves its own
share silent, this one not. None for a family that counts no FLOPs."""
from perfbench.counts import PEAKS


def read(run):
    fam = run.cell.family
    if run.trace is None or not hasattr(fam, "query_flops"):
        return None
    cfg = run.cell.config
    n_ent = cfg["graph"]["n_entities"]
    flops = sum(fam.query_flops(cfg, run.pool[s.index].pattern, n_ent)
                for s in run.answered())
    return 100.0 * flops / run.window.seconds / PEAKS["tf32_flops_per_s"]
