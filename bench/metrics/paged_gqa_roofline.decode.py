"""Paged GQA decode attention's share of its roofline, in percent: the
least time the bytes its rows' contexts need (``costs.paged_gqa_bytes``:
K/V rows read once, q read and the output written) and its products take
on the card, over the traced time in which ``paged_gqa_partial`` or
``paged_gqa_combine`` ran (their union: the combine is launched early
behind the partial and waits on it).  Nothing to read where those
kernels did not run."""
from bench import costs
from bench.trace import kernel_time


def read(rec):
    tr = rec["trace"]
    if rec["mode"] != "decode" or not tr or not rec["peaks"]:
        return None
    t = kernel_time(tr, "paged_gqa_partial", "paged_gqa_combine")
    if t <= 0:
        return None
    cfg = rec["config"]
    need = costs.roofline_s(
        costs.attention_flops(cfg, sum(tr["contexts"])),
        costs.paged_gqa_bytes(cfg, tr["contexts"]), rec["peaks"])
    return 100.0 * need / t
