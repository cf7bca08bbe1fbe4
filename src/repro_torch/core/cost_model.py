"""Cost model: per-segment compute/transfer costs + hardware profiles.

This is the substrate every surveyed planner runs on (Neurosurgeon [35],
DADS [32], Edgent [47,48], DDNN [65], CoEdge [79], ...).  The survey's
Table 2 hardware entries are encoded verbatim as `DeviceProfile`s; wireless /
WAN links follow the scenario constants used across the surveyed papers.

A verbatim copy of the reference package's ``core/cost_model.py`` (the
port imports nothing of it), so the planners route exactly as the
reference does.  The profiles are the planners' model of the survey's
tiers: the tiered cluster's virtual clocks are priced from them, and no
number derived from them is a time measured on the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import build_plan, layer_kind, shared_attn_sites


# ---------------------------------------------------------------------------
# Hardware profiles — survey Table 2
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DeviceProfile:
    name: str
    tier: str                     # cloud | edge | device
    peak_flops: float             # FLOP/s (effective, fp16/bf16)
    mem_bytes: float
    mem_bw: float                 # bytes/s
    compute_w: float              # active power draw, watts
    idle_w: float = 0.5
    utilization: float = 0.35     # achievable fraction of peak on DNN layers

    @property
    def eff_flops(self) -> float:
        return self.peak_flops * self.utilization


@dataclass(frozen=True)
class LinkProfile:
    name: str
    bandwidth: float              # bytes/s
    rtt: float                    # seconds (one-way latency approximated rtt/2)
    tx_w: float = 1.1             # transmit power at the sender, watts
    rx_w: float = 0.7

    def tx_time(self, nbytes: float) -> float:
        return self.rtt / 2 + nbytes / self.bandwidth

    def tx_energy(self, nbytes: float) -> float:
        return (nbytes / self.bandwidth) * self.tx_w


T = 1e12
G = 1e9
M = 1e6

# Survey Table 2 (popular DL hardware), effective numbers
TABLE2: Dict[str, DeviceProfile] = {
    "v100": DeviceProfile("v100", "cloud", 112 * T, 32 * G, 900 * G, 300.0, utilization=0.45),
    "a100": DeviceProfile("a100", "cloud", 78 * T, 40 * G, 1555 * G, 400.0, utilization=0.5),
    "rtx3090": DeviceProfile("rtx3090", "edge", 35.58 * T, 24 * G, 936 * G, 350.0),
    "jetson-agx-xavier": DeviceProfile("jetson-agx-xavier", "edge", 32 * T, 32 * G, 136.5 * G, 30.0),
    "jetson-xavier-nx": DeviceProfile("jetson-xavier-nx", "edge", 21 * T, 8 * G, 51.2 * G, 15.0),
    "jetson-tx2": DeviceProfile("jetson-tx2", "device", 1.33 * T, 8 * G, 59.7 * G, 15.0, idle_w=5.0),
    "jetson-nano": DeviceProfile("jetson-nano", "device", 0.47 * T, 4 * G, 25.6 * G, 10.0, idle_w=2.0),
    "edge-tpu": DeviceProfile("edge-tpu", "device", 4 * T, 1 * G, 25.6 * G, 2.0),
    "raspberry-pi-4b": DeviceProfile("raspberry-pi-4b", "device", 13.5 * G, 4 * G, 8.5 * G, 5.0),
    "iphone-13": DeviceProfile("iphone-13", "device", 15.8 * T, 4 * G, 34 * G, 6.0),
    "honor-magic3": DeviceProfile("honor-magic3", "device", 26 * T, 8 * G, 44 * G, 6.0),
    "pixel6": DeviceProfile("pixel6", "device", 20 * T, 8 * G, 44 * G, 6.0),
    # the mobile SoC class the cloud-device papers (Neurosurgeon [35],
    # JointDNN [38]) actually measured on (Jetson TK1 / 2016 phone era)
    "jetson-tk1": DeviceProfile("jetson-tk1", "device", 0.3 * T, 2 * G, 14.9 * G,
                                 11.0, utilization=0.2),
}

LINKS: Dict[str, LinkProfile] = {
    "wan": LinkProfile("wan", 10 * M / 8, 0.06),          # 10 Mbps WAN to cloud
    "wifi": LinkProfile("wifi", 80 * M / 8, 0.004),       # 80 Mbps WLAN to edge
    "lte": LinkProfile("lte", 20 * M / 8, 0.03),
    "d2d": LinkProfile("d2d", 160 * M / 8, 0.002),        # device-to-device
    "lan": LinkProfile("lan", 1 * G / 8, 0.001),          # 1 Gbps edge LAN
    # accelerator-interconnect links of the reference; already bytes/s
    "ici": LinkProfile("ici", 50 * G, 2e-6, tx_w=0.0, rx_w=0.0),
    "dcn": LinkProfile("dcn", 6.25 * G, 1e-4, tx_w=0.0, rx_w=0.0),
}

# the reference's TPU v5e profile, kept so the copied tables are whole
TPU_V5E = DeviceProfile("tpu-v5e", "cloud", 197 * T, 16 * G, 819 * G, 200.0,
                        utilization=0.55)


# ---------------------------------------------------------------------------
# Segment cost graph derived from a ModelConfig
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SegmentCost:
    """Cost of one plan segment (between two candidate partition points)."""
    index: int
    n_layers: int
    flops: float                  # forward FLOPs for the whole batch
    param_bytes: float
    out_bytes: float              # boundary activation size (what a cut ships)
    has_exit_after: bool


@dataclass(frozen=True)
class CostGraph:
    """Chain cost graph for one (config, batch, seq) workload."""
    config_name: str
    batch: int
    seq_len: int
    input_bytes: float            # raw input size (cloud-only baseline ships this)
    segments: Tuple[SegmentCost, ...]
    result_bytes: float           # final result size shipped back

    @property
    def total_flops(self) -> float:
        return sum(s.flops for s in self.segments)

    def cut_points(self) -> List[int]:
        """Valid cut indices: 0 (all remote) .. len(segments) (all local)."""
        return list(range(len(self.segments) + 1))


def _layer_flops(cfg: ModelConfig, kind: str, batch: int, seq: int,
                 bytes_per_el: int = 2) -> Tuple[float, float]:
    """(flops, param_bytes) for ONE layer of `kind`, full batch forward."""
    d = cfg.d_model
    tok = batch * seq
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads

    def attn_cost():
        if cfg.attention == "mla":
            qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
            qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            p = d * qr + qr * nq * qk + d * (kvr + cfg.qk_rope_head_dim)
            p += kvr * nq * (cfg.qk_nope_head_dim + cfg.v_head_dim) + nq * cfg.v_head_dim * d
        else:
            p = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        f = 2.0 * tok * p
        ctx = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
        f += 2.0 * tok * nq * hd * ctx * 2  # scores + context
        return f, p

    def ffn_cost(ff):
        mult = 3 if cfg.act in ("silu", "geglu") else 2
        p = mult * d * ff
        return 2.0 * tok * p, p

    if kind in ("dense", "enc"):
        fa, pa = attn_cost()
        ff_, pf = ffn_cost(cfg.d_ff)
        return fa + ff_, (pa + pf) * bytes_per_el
    if kind == "decx":
        fa, pa = attn_cost()
        fc, pc = attn_cost()
        ff_, pf = ffn_cost(cfg.d_ff)
        return fa + fc + ff_, (pa + pc + pf) * bytes_per_el
    if kind == "moe":
        fa, pa = attn_cost()
        m = cfg.moe
        fe, pe_one = ffn_cost(m.d_ff_expert)
        active = fe * (m.top_k + m.num_shared_experts)
        p = pe_one * m.num_experts + pe_one * m.num_shared_experts + d * m.num_experts
        f_router = 2.0 * tok * d * m.num_experts
        return fa + active + f_router, (pa + p) * bytes_per_el
    if kind == "pair":
        f1, p1 = _layer_flops(cfg, "dense", batch, seq, 1)
        f2, p2 = _layer_flops(cfg, "moe", batch, seq, 1)
        return f1 + f2, (p1 + p2) * bytes_per_el
    if kind == "mamba":
        s = cfg.ssm
        d_in = s.expand * d
        p = d * (2 * d_in + 2 * s.state_size) + d_in * d
        f = 2.0 * tok * p
        f += 2.0 * tok * d_in * s.state_size * 2          # SSD state update + read
        f += 2.0 * tok * s.chunk_size * s.state_size      # intra-chunk scores
        return f, p * bytes_per_el
    if kind in ("mlstm", "slstm"):
        d_in = int(cfg.ssm.proj_factor * d)
        p = 3 * d * d_in + 3 * d_in * d_in + 2 * d_in * (cfg.num_heads if kind == "slstm" else 1)
        f = 2.0 * tok * p
        if kind == "mlstm":
            f += 2.0 * tok * cfg.ssm.chunk_size * d_in    # chunk dual
        return f, p * bytes_per_el
    raise ValueError(kind)


def build_cost_graph(cfg: ModelConfig, batch: int, seq_len: int,
                     bytes_per_act: int = 2,
                     input_bytes_per_token: float = 4.0) -> CostGraph:
    """Derive the chain cost graph from the model's plan."""
    plan = build_plan(cfg)
    act_bytes = float(batch * seq_len * cfg.d_model * bytes_per_act)
    segs: List[SegmentCost] = []
    idx = 0
    pending_exit = False
    for i, step in enumerate(plan):
        if step[0] == "scan":
            _, kind, n, layer0 = step
            f, pb = _layer_flops(cfg, kind, batch, seq_len)
            has_exit = (i + 1 < len(plan) and plan[i + 1][0] == "exit")
            # fold a following shared_attn into this segment's cost
            if i + 1 < len(plan) and plan[i + 1][0] == "shared_attn":
                fs, ps = _layer_flops(cfg, "dense", batch, seq_len)
                f_total = f * n + fs
                pb_total = pb * n   # shared weights counted once, below
                has_exit = (i + 2 < len(plan) and plan[i + 2][0] == "exit")
            else:
                f_total = f * n
                pb_total = pb * n
            segs.append(SegmentCost(idx, n, f_total, pb_total, act_bytes, has_exit))
            idx += 1
    # raw input: tokens are int32 ids (4B) + any frontend embeddings
    input_bytes = batch * seq_len * input_bytes_per_token
    if cfg.frontend != "none":
        input_bytes += batch * cfg.frontend_tokens * cfg.d_model * bytes_per_act
    result_bytes = float(batch * 4)   # one class/token id back
    return CostGraph(cfg.name, batch, seq_len, input_bytes, tuple(segs),
                     result_bytes)


# ---------------------------------------------------------------------------
# Primitive cost queries used by every planner
# ---------------------------------------------------------------------------

def kv_cache_bytes_per_token(cfg: ModelConfig, bytes_per_el: int = 2) -> float:
    """Per-token KV-cache footprint — what a prefill/decode split ships
    across the tier boundary (attention k+v per layer; SSM/xLSTM state is
    per-sequence, approximated by one layer's width here)."""
    if cfg.attention == "mla":
        per_layer = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per_layer = 2 * cfg.num_kv_heads * cfg.resolved_head_dim
    return float(cfg.num_layers * per_layer * bytes_per_el)


def compute_time(flops: float, dev: DeviceProfile) -> float:
    return flops / dev.eff_flops


def compute_energy(flops: float, dev: DeviceProfile) -> float:
    return compute_time(flops, dev) * dev.compute_w


def segment_range_cost(graph: CostGraph, lo: int, hi: int) -> float:
    """Total FLOPs of segments [lo, hi)."""
    return sum(s.flops for s in graph.segments[lo:hi])
