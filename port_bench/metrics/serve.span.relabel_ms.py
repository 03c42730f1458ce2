"""Mean time, on the host's clock, of a request's "serve.relabel" span (the
panoptic relabelling, host work) over the profiled stretch's requests."""

from port_bench.spans import mean_span_ms


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return mean_span_ms("serve.request", "serve.relabel", "host")
