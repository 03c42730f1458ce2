"""The rate of a request's copies to the host: the bytes of the counter
"serve.to_host_bytes" over the device time of the "serve.to_host" span,
summed over the profiled stretch's requests, in GB/s (1e9 bytes)."""

from port_bench.spans import roots, span_ms


def read(rec):
    if rec.get("kind") != "serve":
        return None
    found = [r for r in roots("serve.request") if "serve.to_host_bytes" in r["counters"]]
    ms = sum(span_ms(r, "serve.to_host", "device") for r in found)
    if ms <= 0:
        return None
    return sum(r["counters"]["serve.to_host_bytes"] for r in found) / (ms * 1e6)
