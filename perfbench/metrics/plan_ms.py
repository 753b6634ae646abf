"""Host milliseconds a micro-batch in the executor's ``plan`` span (the plan
compiler and the schedule, inside ``encode``)."""
from perfbench.lanes import on_card


def read(run):
    return run.span_ms("plan") if on_card(run) else None
