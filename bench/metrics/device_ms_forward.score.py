"""Device milliseconds a forward: the time in which some device
operation ran in the traced window (``busy_s``, the union of their
intervals) over the forwards traced."""


def read(rec):
    tr = rec["trace"]
    if rec["mode"] != "score" or not tr or not tr["forwards"]:
        return None
    return tr["busy_s"] / tr["forwards"] * 1e3
