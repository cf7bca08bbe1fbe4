"""A Zamba2 hybrid's decode window as a share of the card's bf16 peak,
in percent: the hybrid's model FLOPs (``hybrid_costs.decode_flops``) of
every token committed in the measured window over the peak times the
window's wall time.  The window's keys are recovered from the runner's
``flops``, which ``costs.decode_flops`` counted as if every layer were a
dense GQA layer (``hybrid_costs.keys_from_flops``).  Nothing to read for
a configuration without sites."""
from bench import hybrid_costs


def read(rec):
    cfg = rec["config"]
    if rec["mode"] != "decode" or not rec["peaks"] or not rec["window_s"] \
            or not cfg.get("hybrid_layer_ids"):
        return None
    keys = hybrid_costs.keys_from_flops(cfg, rec["flops"], rec["tokens"])
    flops = hybrid_costs.decode_flops(cfg, rec["tokens"], keys)
    return 100.0 * flops / (rec["peaks"]["bf16_flops"] * rec["window_s"])
