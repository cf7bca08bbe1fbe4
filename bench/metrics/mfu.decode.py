"""The decode window's share of the card's bf16 peak, in percent: the
model FLOPs of every token committed in the measured window
(``bench/costs.py``) over the peak times the window's wall time."""


def read(rec):
    if rec["mode"] != "decode" or not rec["peaks"] or not rec["window_s"]:
        return None
    return 100.0 * rec["flops"] / (rec["peaks"]["bf16_flops"]
                                   * rec["window_s"])
