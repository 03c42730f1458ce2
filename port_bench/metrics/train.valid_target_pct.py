"""The share of the criterion's target slots that hold a target: 100 x the
counter "targets.valid" over "targets.slots", summed over the marked and
the profiled stretch's train steps, in percent."""

from port_bench.spans import roots


def read(rec):
    if rec.get("kind") != "train":
        return None
    found = [r["counters"] for r in roots("train.step") if r["counters"].get("targets.slots")]
    if not found:
        return None
    return 100.0 * sum(c["targets.valid"] for c in found) / sum(c["targets.slots"] for c in found)
