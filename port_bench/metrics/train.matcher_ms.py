"""Mean time of a train step's matching: the matcher's costs and the
assignment (marks "matcher_costs" + "assign"), over the marked stretch."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    st = rec["stages_ms"]
    return st["matcher_costs"] + st["assign"] if "matcher_costs" in st and "assign" in st else None
