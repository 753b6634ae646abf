"""The 95th percentile of the client-side latency, submit to result, of every
request answered inside the window."""
import numpy as np


def read(run):
    lat = [(s.t_done - s.t_submit) * 1e3 for s in run.answered()]
    return float(np.percentile(lat, 95)) if lat else None
