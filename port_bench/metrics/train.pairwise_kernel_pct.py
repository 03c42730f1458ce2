"""The share of the weak matcher's pairwise-cost calls that launched the
hand-written kernel: 100 x the counter "costs.pairwise_kernel" over
"costs.pairwise_calls", summed over the marked and the profiled stretch's
train steps, in percent."""

from port_bench.spans import roots


def read(rec):
    if rec.get("kind") != "train":
        return None
    found = [r["counters"] for r in roots("train.step")
             if r["counters"].get("costs.pairwise_calls")]
    if not found:
        return None
    return 100.0 * sum(c.get("costs.pairwise_kernel", 0) for c in found) / sum(
        c["costs.pairwise_calls"] for c in found)
