"""Mean time of a train step's clip and AdamW update (mark "optimizer"),
over the marked stretch."""


def read(rec):
    return rec["stages_ms"].get("optimizer") if rec.get("kind") == "train" else None
