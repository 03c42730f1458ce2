"""Mean time, on the device's clock, of a request's "serve.prepare" span
(padding, the copy in, normalisation) over the profiled stretch's
requests."""

from port_bench.spans import mean_span_ms


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return mean_span_ms("serve.request", "serve.prepare", "device")
