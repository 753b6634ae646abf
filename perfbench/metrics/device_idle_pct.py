"""The share of the traced window in which nothing ran on the card: one
minus the union of every kernel's, copy's and set's interval."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
