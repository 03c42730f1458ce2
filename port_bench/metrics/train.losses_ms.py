"""Mean time of a train step's loss terms after the assignment (mark
"losses"), over the marked stretch."""


def read(rec):
    return rec["stages_ms"].get("losses") if rec.get("kind") == "train" else None
