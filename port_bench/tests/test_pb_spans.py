"""The readers of the program's spans and counters: each reads only its own
kind of run, averages over the roots it finds, and gives None, without
raising, where the program has no tracing module or no such root."""

import re
import sys

import pytest

from port_bench import manifest, spans

# the per-layer metrics read from the spans and counters
NEW = [m["name"] for m in manifest.benchmark()["per_layer"]
       if "port_bench.spans" in (manifest.HERE / "metrics" / f"{m['name']}.py").read_text()]


def names_in(metric):
    """The dotted names quoted in a reader's source: its roots, spans and
    counters."""
    src = (manifest.HERE / "metrics" / f"{metric}.py").read_text()
    return set(re.findall(r'"([a-z_]+(?:\.[a-z0-9_]+)+)"', src))


def fake_roots(monkeypatch, roots):
    monkeypatch.setattr(spans, "roots", lambda name: [r for r in roots if r["name"] == name])


def root(name, spans_, counters=None):
    return {"name": name, "counters": counters or {},
            "spans": [{"name": n, "device_ms": d, "host_ms": h} for n, d, h in spans_]}


@pytest.mark.parametrize("metric", NEW)
def test_without_the_tracing_module_a_reader_gives_none(metric, monkeypatch):
    import bm2f_tpu_torch.utils

    monkeypatch.delattr(bm2f_tpu_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "bm2f_tpu_torch.utils.tracing", None)
    assert spans.roots("serve.request") == []
    kind = "serve" if metric.startswith("serve.") else "train"
    assert manifest.reader(metric)({"kind": kind}) is None


def test_the_readers_average_over_their_roots(monkeypatch):
    # every reader reads a value from roots that hold every name they quote
    names = sorted(set().union(*map(names_in, NEW)))
    whole = [root(n, [(s, 1.0, 2.0) for s in names], {c: 1 for c in names}) for n in names]
    fake_roots(monkeypatch, whole)
    for m in NEW:
        rec = {"kind": "serve" if m.startswith("serve.") else "train"}
        assert isinstance(manifest.reader(m)(rec), float), m

    fake_roots(monkeypatch, [
        root("serve.request", [("serve.request", 9, 9), ("serve.to_host", 2.0, 2.5),
                               ("serve.relabel", 0.1, 1.0)], {"serve.to_host_bytes": 4e6}),
        root("serve.request", [("serve.request", 9, 9), ("serve.to_host", 6.0, 6.5),
                               ("serve.relabel", 0.1, 3.0)], {"serve.to_host_bytes": 12e6}),
        root("train.step", [("costs.projection", 1.0, 5.0), ("costs.projection", 2.0, 5.0),
                            ("assign.solve", 0.5, 4.0)],
             {"targets.valid": 3, "targets.slots": 200}),
        root("train.step", [("costs.projection", 3.0, 5.0), ("assign.solve", 0.5, 2.0)],
             {"targets.valid": 13, "targets.slots": 200}),
    ])
    serve, train = {"kind": "serve"}, {"kind": "train"}
    read = lambda m, rec: manifest.reader(m)(rec)
    assert read("serve.span.to_host_ms", serve) == 4.0
    assert read("serve.span.relabel_ms", serve) == 2.0
    assert read("serve.to_host_gbps", serve) == pytest.approx(16e6 / 8.0 / 1e6)
    assert read("serve.span.prepare_ms", serve) is None
    assert read("train.span.projection_cost_ms", train) == 3.0
    assert read("train.span.assign_solve_ms", train) == 3.0
    assert read("train.valid_target_pct", train) == 4.0
    assert read("train.span.pairwise_cost_ms", train) is None
    for m in NEW:
        other = train if m.startswith("serve.") else serve
        assert read(m, other) is None
