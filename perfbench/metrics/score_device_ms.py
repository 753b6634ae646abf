"""The card's milliseconds a micro-batch from the end of the encode to the
end of the all-entity score's launches, before the copy to the host: the
mean ``score.device`` span on the engine's device lane."""
from perfbench.lanes import mean_device_ms


def read(run):
    return mean_device_ms(run, "score.device")
