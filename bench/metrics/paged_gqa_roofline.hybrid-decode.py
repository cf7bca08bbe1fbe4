"""The shared-attention sites' paged GQA decode attention (Zamba2's head
224, G 1 instance) as a share of its roofline, in percent: the least
time the bytes its rows' contexts need at every site
(``hybrid_costs.paged_gqa_bytes``: K/V rows read once, q read and the
output written) and its products take on the card, over the traced time
in which ``paged_gqa_partial`` or ``paged_gqa_combine`` ran (their
union).  Nothing to read for a configuration without sites, or where
those kernels did not run."""
from bench import costs, hybrid_costs
from bench.trace import kernel_time


def read(rec):
    tr, cfg = rec["trace"], rec["config"]
    if rec["mode"] != "decode" or not tr or not rec["peaks"] \
            or not cfg.get("hybrid_layer_ids"):
        return None
    t = kernel_time(tr, "paged_gqa_partial", "paged_gqa_combine")
    if t <= 0:
        return None
    need = costs.roofline_s(
        hybrid_costs.attention_flops(cfg, sum(tr["contexts"])),
        hybrid_costs.paged_gqa_bytes(cfg, tr["contexts"]), rec["peaks"])
    return 100.0 * need / t
