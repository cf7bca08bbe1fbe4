"""Device milliseconds a decode step: the time in which some
device operation ran in the traced window (``busy_s``, the union of
their intervals) over the decode steps traced."""


def read(rec):
    tr = rec["trace"]
    if rec["mode"] != "decode" or not tr or not tr["steps"]:
        return None
    return tr["busy_s"] / tr["steps"] * 1e3
