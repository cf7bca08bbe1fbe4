"""The flash forward's share of its roofline, in percent: the least time
the causal products and q, k, v and o bytes of the traced forwards take
on the card (``costs.flash_fwd_flops`` / ``flash_fwd_bytes``, from
shapes), over the traced time of ``flash_fwd_kernel``.  Nothing to read
where that kernel did not run."""
from bench import costs
from bench.trace import kernel_time


def read(rec):
    tr = rec["trace"]
    if rec["mode"] != "score" or not tr or not rec["peaks"]:
        return None
    t = kernel_time(tr, "flash_fwd_kernel")
    if t <= 0:
        return None
    cfg, n = rec["config"], tr["forwards"]
    need = costs.roofline_s(
        n * costs.flash_fwd_flops(cfg, tr["batch"], tr["seq"]),
        n * costs.flash_fwd_bytes(cfg, tr["batch"], tr["seq"]),
        rec["peaks"])
    return 100.0 * need / t
