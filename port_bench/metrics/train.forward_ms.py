"""Mean host-clock time of a train step's forward (`Trainer.step` mark
"forward", which synchronises the device), over the marked stretch."""


def read(rec):
    return rec["stages_ms"].get("forward") if rec.get("kind") == "train" else None
