"""Mean time a request spends in Swin's window attention, its
"swin.window_attn" spans (each block's attention core: the scores, bias,
mask, softmax and the product with v) on the device's clock, over the
profiled stretch's requests."""

from port_bench.spans import mean_span_ms


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return mean_span_ms("serve.request", "swin.window_attn", "device")
