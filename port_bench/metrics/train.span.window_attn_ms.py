"""Mean time a train step spends in Swin's window attention, its
"swin.window_attn" spans (each block's attention core in the forward: the
scores, bias, mask, softmax and the product with v) on the device's clock,
over the marked and the profiled stretch's steps."""

from port_bench.spans import mean_span_ms


def read(rec):
    if rec.get("kind") != "train":
        return None
    return mean_span_ms("train.step", "swin.window_attn", "device")
