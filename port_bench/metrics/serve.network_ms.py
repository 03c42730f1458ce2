"""Mean time of the network's forward inside `Predictor.infer`, between a
pre- and a post-hook on the predictor's model that each synchronise the
device, over the marked stretch."""


def read(rec):
    return rec.get("network_ms") if rec.get("kind") == "serve" else None
