"""Mean time of the rest of a request in the marked stretch: padding and
the copy in, the resize, the three inference modes, the copy to the host
and the panoptic relabelling (the request's time less the network's)."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    return rec["request_ms"] - rec["network_ms"]
