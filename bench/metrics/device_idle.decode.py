"""Share of the traced decode window in which no device operation ran,
in percent."""


def read(rec):
    tr = rec["trace"]
    if rec["mode"] != "decode" or not tr or not tr["window_s"]:
        return None
    return 100.0 * (tr["window_s"] - tr["busy_s"]) / tr["window_s"]
