"""Host milliseconds a micro-batch in the engine's ``score`` span."""


def read(run):
    return run.span_ms("score")
