"""The whole train step's share of the card's peak: the network's forward
and backward FLOPs (3 x the forward, counted on the plain reference at the
cell's canvas and batch) of every step of the plain stretch, over
its time, against the published peak of the configuration's precision
(`bounds.PEAK_FLOPS`), in percent."""

from port_bench.bounds import PEAK_FLOPS


def read(rec):
    if rec.get("kind") != "train" or not rec["plain"]["steps"]:
        return None
    p = rec["plain"]
    return 100.0 * p["flops"] / p["seconds"] / PEAK_FLOPS[rec["precision"]]
