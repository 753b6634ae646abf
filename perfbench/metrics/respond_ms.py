"""Host milliseconds a micro-batch in the engine's ``respond`` span: its
futures resolved, the clients' done-callbacks (and so their next sends)
included."""
from perfbench.lanes import on_card


def read(run):
    return run.span_ms("respond") if on_card(run) else None
