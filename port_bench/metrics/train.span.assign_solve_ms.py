"""Mean time a train step spends in the host LAP solve, its "assign.solve"
spans on the host's clock, over the marked and the profiled stretch's
steps."""

from port_bench.spans import mean_span_ms


def read(rec):
    if rec.get("kind") != "train":
        return None
    return mean_span_ms("train.step", "assign.solve", "host")
