"""The whole request's share of the card's peak: the network's forward
FLOPs at each request's padded shape (counted on the plain reference) over
the plain stretch's time, against the f32 peak (the served precision,
without TF32), in percent."""

from port_bench.bounds import PEAK_FLOPS


def read(rec):
    if rec.get("kind") != "serve" or not rec["plain"]["requests"]:
        return None
    p = rec["plain"]
    return 100.0 * p["flops"] / p["seconds"] / PEAK_FLOPS[rec["precision"]]
