"""Roofline terms of one step on one NVIDIA H100, the counterpart of the
reference's ``launch/roofline.py`` (which prices TPU chips):

    compute    = flops / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective_bytes / LINK_BW

per device: ``flops`` and ``bytes`` are a device's share of the step
(``launch.op_cost`` counts the port's own eager step), and
``collective`` its collectives' output bytes by kind
(``collective_bytes_from_log`` over ``sharding.comm.count_collectives``),
all-reduce counted twice (the reduce-scatter and all-gather phases of a
ring), as the reference counts them.  ``collective`` is None where no
collective was recorded because the step issues none (the dry run: the
port has no tensor-parallel partitioner); the collective term is then
None too, never a guess.

This module imports nothing, so ``chip_smoke.py`` reads the peaks from
it before it imports torch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_FLOPS = 989e12       # bf16 tensor-core FLOP/s
INT8_PEAK = 1979e12       # int8 tensor-core OP/s
HBM_BW = 3.35e12          # HBM3 bytes/s
HBM_BYTES = 80e9          # device memory
LINK_BW = 450e9           # NVLink bytes/s, each way

# kinds and their weights in the collective term: the reference's HLO
# kinds (send / recv is a collective-permute), plus the port's broadcast
# (the reference's psum of the last stage's logits against zeros; one
# pass of the tensor, weight 1)
COLLECTIVES = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
}


def collective_bytes_from_log(records: Iterable[Dict]) -> Dict[str, float]:
    """Per-kind output bytes (this rank's) from the records of
    ``sharding.comm.count_collectives()``."""
    out = {k: 0.0 for k in COLLECTIVES}
    for r in records:
        out[r["kind"]] += float(r["bytes"])
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                      # per device (op_cost's count)
    hlo_bytes: float                      # per device
    collective: Optional[Dict[str, float]]  # per-device bytes by kind
    model_flops: float                    # 6*N*D (train) or 2*N_active*tok
    peak_bytes_per_device: Optional[float] = None

    @property
    def collective_bytes(self) -> Optional[float]:
        if self.collective is None:
            return None
        return sum(v * COLLECTIVES[k] for k, v in self.collective.items())

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> Optional[float]:
        cb = self.collective_bytes
        return None if cb is None else cb / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory}
        if self.t_collective is not None:
            terms["collective"] = self.t_collective
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops * self.chips, 1.0)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective": self.collective,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_bytes_per_device": self.peak_bytes_per_device,
        }


def model_flops_for(cfg, shape, kind: str) -> float:
    """Reference useful FLOPs: 6*N_active*tokens (train) / 2*N_active*tokens
    (one decode step) — the §Roofline MODEL_FLOPS term."""
    n = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    if kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per request
