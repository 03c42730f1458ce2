"""Swin's window attention in the train step's forward against its
roofline: the least time of the work the counters "swin.attn_flops" and
"swin.attn_bytes" count (the two products over the padded windows; q, k, v
read and the output written once), max(bytes / PEAK_BYTES_PER_S, FLOPs /
the configuration precision's peak), over the device time of the
"swin.window_attn" spans, summed over the marked and the profiled
stretch's steps, in percent."""

from port_bench.bounds import PEAK_BYTES_PER_S, PEAK_FLOPS
from port_bench.spans import roots, span_ms


def read(rec):
    if rec.get("kind") != "train":
        return None
    found = [r for r in roots("train.step") if "swin.attn_flops" in r["counters"]]
    ms = sum(span_ms(r, "swin.window_attn", "device") for r in found)
    if ms <= 0:
        return None
    peak = PEAK_FLOPS[rec.get("precision", "float32")]
    least = sum(max(r["counters"]["swin.attn_bytes"] / PEAK_BYTES_PER_S,
                    r["counters"]["swin.attn_flops"] / peak) for r in found)
    return 100.0 * least / (ms * 1e-3)
