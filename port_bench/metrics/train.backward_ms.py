"""Mean time of a train step's backward (mark "backward": autograd, with
the deformable core's backward), over the marked stretch."""


def read(rec):
    return rec["stages_ms"].get("backward") if rec.get("kind") == "train" else None
