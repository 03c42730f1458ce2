"""The share of the profiled stretch's requests that took every pinned host
block they copied through from the caching allocator's cache: 100 x the
"serve.request" roots whose counter "serve.pinned_new_blocks" is 0, over
the roots that have the counter, in percent. A program that does not count
its pinned blocks gives None."""

from port_bench.spans import roots


def read(rec):
    if rec.get("kind") != "serve":
        return None
    found = [r["counters"]["serve.pinned_new_blocks"] for r in roots("serve.request")
             if "serve.pinned_new_blocks" in r["counters"]]
    if not found:
        return None
    return 100.0 * sum(n == 0 for n in found) / len(found)
