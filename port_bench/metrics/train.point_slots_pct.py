"""The share of the criterion's target slots that its point-sampled mask
losses take: 100 x the counter "targets.point_slots" over "targets.slots",
summed over the marked and the profiled stretch's train steps that count
it, in percent. A criterion that point-samples no targets (the box
criterion), or a program that does not count them, gives None."""

from port_bench.spans import roots


def read(rec):
    if rec.get("kind") != "train":
        return None
    found = [r["counters"] for r in roots("train.step")
             if r["counters"].get("targets.point_slots") is not None]
    if not found:
        return None
    return (100.0 * sum(c["targets.point_slots"] for c in found)
            / sum(c["targets.slots"] for c in found))
