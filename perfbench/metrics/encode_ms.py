"""Host milliseconds a micro-batch in the engine's ``encode`` span."""


def read(run):
    return run.span_ms("encode")
