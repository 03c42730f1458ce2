"""The reader of the counter "serve.pinned_new_blocks": the share of the
served requests that allocated no pinned host block, None where no request
counts its blocks (a program that does not)."""

import sys

import pytest

from port_bench import manifest, spans


def READ(rec):
    """The reader loaded anew, so that it takes `spans.roots` as patched."""
    return manifest.reader("serve.pinned_reuse_pct")(rec)


def request(counters):
    return {"name": "serve.request", "counters": counters,
            "spans": [{"name": "serve.request", "device_ms": 9.0, "host_ms": 9.0}]}


def test_it_reads_only_served_runs_with_the_counter(monkeypatch):
    import bm2f_tpu_torch.utils

    monkeypatch.delattr(bm2f_tpu_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "bm2f_tpu_torch.utils.tracing", None)
    assert READ({"kind": "serve"}) is None
    monkeypatch.setattr(spans, "roots", lambda name: [
        request({"serve.to_host_bytes": 4e6})] if name == "serve.request" else [])
    assert READ({"kind": "serve"}) is None
    assert READ({"kind": "train"}) is None


def test_it_is_the_share_of_requests_that_allocated_no_block(monkeypatch):
    roots = [request({"serve.to_host_bytes": 4e6, "serve.pinned_new_blocks": n})
             for n in (0, 3, 0, 0)]
    roots.append(request({"serve.to_host_bytes": 4e6}))  # not counted: not read
    roots.append({"name": "train.step", "counters": {"serve.pinned_new_blocks": 5}, "spans": []})
    monkeypatch.setattr(spans, "roots", lambda name: [r for r in roots if r["name"] == name])
    assert READ({"kind": "serve"}) == pytest.approx(75.0)
    assert READ({"kind": "train"}) is None
    roots[1]["counters"]["serve.pinned_new_blocks"] = 0
    assert READ({"kind": "serve"}) == 100.0
