"""Requests a micro-batch, from the serving engine's counters over the
window: its real rows (padding left out) plus duplicates coalesced onto
them."""


def read(run):
    st = run.stats
    if not st.get("batches"):
        return None
    real = st["mean_batch_size"] * (1.0 - st["padded_row_frac"])
    return real + st["coalesced"] / st["batches"]
