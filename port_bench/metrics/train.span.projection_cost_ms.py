"""Mean time a train step spends in the weak matcher's projection costs,
its "costs.projection" spans (an image and a layer each) on the device's
clock, over the marked and the profiled stretch's steps."""

from port_bench.spans import mean_span_ms


def read(rec):
    if rec.get("kind") != "train":
        return None
    return mean_span_ms("train.step", "costs.projection", "device")
