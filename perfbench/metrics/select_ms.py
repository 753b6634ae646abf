"""Host milliseconds a micro-batch in the engine's ``select`` span."""


def read(run):
    return run.span_ms("select")
