"""The card's milliseconds a micro-batch from the end of the plan to the end
of the encode's launches: the mean ``encode.device`` span on the engine's
device lane (CUDA events on the batcher's stream)."""
from perfbench.lanes import mean_device_ms


def read(run):
    return mean_device_ms(run, "encode.device")
