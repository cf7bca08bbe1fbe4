"""Model configuration for the PyTorch port.

A copy of the reference package's ``configs/base.py``: the dataclasses,
the four assigned input shapes (``INPUT_SHAPES``) and the analytic
arithmetic the dry run and the roofline read (``param_count``,
``active_param_count``, ``flops_per_token``, ``supports_long_context``).
Field names, defaults, the ``reduced()`` smoke derivation and every
formula are kept identical, so a config built here describes the same
model, and counts the same parameters, as the reference config of the
same name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # routed experts
    top_k: int = 1
    num_shared_experts: int = 0
    d_ff_expert: int = 0           # per-expert FFN width
    capacity_factor: float = 1.25  # dispatch capacity factor
    layer_period: int = 1          # every `period`-th layer is MoE (1 = all)
    first_dense_layers: int = 0    # leading dense layers (DeepSeek-V3: 3)
    router_aux_coef: float = 0.01  # load-balance aux loss coefficient


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    slstm_layers: Tuple[int, ...] = ()
    proj_factor: float = 2.0

    @property
    def n_groups(self) -> int:
        """Mamba2 B/C groups (``GroupedSSMConfig`` sets them): one."""
        return 1


@dataclass(frozen=True)
class GroupedSSMConfig(SSMConfig):
    """Mamba2 with grouped B/C: head h reads group h // (H / G), and the
    gated norm normalizes each group of channels on its own (Zamba2-7B:
    G 2).  A subclass, so that the reference's configs, which have no
    groups, convert field for field."""
    n_groups: int = 1


@dataclass(frozen=True)
class EncDecConfig:
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500


@dataclass(frozen=True)
class ExitConfig:
    """Early-exit configuration: after layer ``i`` (1-based count of layers
    completed) in ``exit_layers`` an exit head may fire."""
    exit_layers: Tuple[int, ...] = ()
    entropy_threshold: float = 0.5
    head_hidden: int = 0           # 0 = linear head straight to vocab


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    attention: str = "full"        # full | sliding | mla
    sliding_window: int = 0
    long_context_window: int = 8192
    rope: str = "rope"             # rope | mrope | none
    rope_theta: float = 10_000.0
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    encdec: EncDecConfig = field(default_factory=EncDecConfig)
    exits: ExitConfig = field(default_factory=ExitConfig)
    shared_attn_period: int = 0
    frontend: str = "none"
    frontend_tokens: int = 0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "silu"              # silu | gelu | geglu (gated erf gelu)
    tie_embeddings: bool = False
    mtp_depth: int = 0
    dtype: str = "bfloat16"
    source: str = ""

    # Zamba2's published shared blocks are fields of ``SiteConfig``; a
    # ModelConfig reads the period layout's values: no explicit sites,
    # one block on the residual stream, 1/sqrt(head_dim) scores
    hybrid_layer_ids = property(lambda self: ())
    num_mem_blocks = property(lambda self: 1)
    site_concat_input = property(lambda self: False)
    site_adapter_rank = property(lambda self: 0)
    site_linear = property(lambda self: False)
    attn_scale = property(lambda self: 0.0)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic long decode: SSM/hybrid state, or a sliding window."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.family == "encdec":
            return False  # whisper: pure full-attention enc-dec, skip long_500k
        return self.sliding_window > 0 or self.long_context_window > 0

    @property
    def is_decoder(self) -> bool:
        return True  # all assigned archs have a decode step

    def segment_boundaries(self) -> Tuple[int, ...]:
        """Sorted exit layers plus the final layer."""
        bounds = sorted(set(self.exits.exit_layers) | {self.num_layers})
        return tuple(b for b in bounds if 0 < b <= self.num_layers)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, <= 4 experts."""
        d_model = min(self.d_model, 256)
        num_heads = max(2, min(self.num_heads, 4))
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        head_dim = max(8, d_model // num_heads)
        moe = self.moe
        if moe.num_experts:
            moe = dataclasses.replace(
                moe,
                num_experts=min(4, moe.num_experts),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(moe.d_ff_expert or 128, 128),
                first_dense_layers=min(moe.first_dense_layers, 1),
            )
        ssm = dataclasses.replace(
            self.ssm,
            state_size=min(self.ssm.state_size, 16),
            head_dim=min(self.ssm.head_dim, 32),
            chunk_size=32,
            slstm_layers=tuple(i for i in self.ssm.slstm_layers if i < 2)
            or ((1,) if self.ssm.slstm_layers else ()),
        )
        encdec = dataclasses.replace(
            self.encdec,
            num_encoder_layers=min(self.encdec.num_encoder_layers, 2),
            encoder_seq_len=min(self.encdec.encoder_seq_len, 32),
        )
        exits = dataclasses.replace(
            self.exits, exit_layers=(1,) if self.exits.exit_layers else ())
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            q_lora_rank=min(self.q_lora_rank, 64),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_head_dim=min(self.qk_nope_head_dim, 32),
            qk_rope_head_dim=min(self.qk_rope_head_dim, 16),
            v_head_dim=min(self.v_head_dim, 32),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            long_context_window=min(self.long_context_window, 64),
            moe=moe,
            ssm=ssm,
            encdec=encdec,
            exits=exits,
            shared_attn_period=(min(self.shared_attn_period, 1)
                                if self.shared_attn_period else 0),
            frontend_tokens=(min(self.frontend_tokens, 16)
                             if self.frontend_tokens else 0),
            mtp_depth=min(self.mtp_depth, 1),
        )

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for Table-1 benchmark + roofline N)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.attention == "mla":
                qr, kvr = self.q_lora_rank, self.kv_lora_rank
                qk = self.qk_nope_head_dim + self.qk_rope_head_dim
                p = d * qr + qr * nq * qk              # q down + up
                p += d * (kvr + self.qk_rope_head_dim)  # kv down (+ shared rope k)
                p += kvr * nq * (self.qk_nope_head_dim + self.v_head_dim)
                p += nq * self.v_head_dim * d          # o proj
                return p
            return d * nq * hd + 2 * d * nkv * hd + nq * hd * d

        def ffn_params(ff: int) -> int:
            mult = 3 if self.act in ("silu", "geglu") else 2  # gated vs plain
            return mult * d * ff

        def moe_layer_params() -> int:
            m = self.moe
            p = d * m.num_experts  # router
            p += m.num_experts * ffn_params(m.d_ff_expert)
            p += m.num_shared_experts * ffn_params(m.d_ff_expert)
            return p

        def ssm_layer_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nheads = max(1, d_in // s.head_dim)
            bc = 2 * s.n_groups * s.state_size
            p = d * (2 * d_in + bc + nheads)  # in_proj(x,z)+B,C,dt
            p += s.conv_width * (d_in + bc)
            p += d_in * d + nheads  # out proj + A
            return p

        def xlstm_layer_params(layer_idx: int) -> int:
            s = self.ssm
            d_in = int(s.proj_factor * d)
            p = 2 * d * d_in + d_in * d  # up (x,z) + down
            p += 3 * d_in * d_in + 3 * d_in  # q,k,v / gates
            return p

        total = emb
        layers = self.num_layers
        for i in range(layers):
            if self.family in ("dense", "vlm"):
                total += attn_params() + ffn_params(self.d_ff)
            elif self.family == "moe":
                total += attn_params()
                m = self.moe
                if i < m.first_dense_layers or (m.layer_period > 1 and (i % m.layer_period) != (m.layer_period - 1)):
                    total += ffn_params(self.d_ff)
                else:
                    total += moe_layer_params()
            elif self.family == "ssm":
                if i in self.ssm.slstm_layers:
                    total += xlstm_layer_params(i)
                else:
                    total += xlstm_layer_params(i)
            elif self.family == "hybrid":
                total += ssm_layer_params()
            elif self.family == "encdec":
                total += attn_params() * 2 + ffn_params(self.d_ff)  # self+cross
            total += 2 * d  # norms
        if self.family == "hybrid" and self.shared_attn_period:
            total += attn_params() + ffn_params(self.d_ff)  # ONE shared block
        if self.family == "hybrid" and self.hybrid_layer_ids:
            d_in = d * (2 if self.site_concat_input else 1)
            attn = (d_in * (nq + 2 * nkv) + nq * d) * hd
            total += self.num_mem_blocks * (attn + ffn_params(self.d_ff)
                                            + d_in + d)
            r = self.site_adapter_rank
            site = (r * (d + 2 * self.d_ff) if r else 0) + (
                d * d if self.site_linear else 0)
            total += len(self.hybrid_layer_ids) * site
        if self.family == "encdec":
            for _ in range(self.encdec.num_encoder_layers):
                total += attn_params() + ffn_params(self.d_ff) + 2 * d
        if self.mtp_depth:
            total += self.mtp_depth * (attn_params() + moe_layer_params() + 2 * d * d)
        # exit heads
        total += len(self.exits.exit_layers) * d * v if not self.tie_embeddings else 0
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        m = self.moe
        full = self.param_count()
        # subtract inactive expert FFNs
        mult = 3 if self.act in ("silu", "geglu") else 2
        per_expert = mult * self.d_model * m.d_ff_expert
        n_moe_layers = sum(
            1 for i in range(self.num_layers)
            if i >= m.first_dense_layers and (m.layer_period <= 1 or (i % m.layer_period) == (m.layer_period - 1))
        )
        inactive = n_moe_layers * (m.num_experts - m.top_k) * per_expert
        return full - inactive

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate forward FLOPs per token: 2*N_active + attention term."""
        n = self.active_param_count() - self.vocab_size * self.d_model  # exclude input embed gather
        f = 2.0 * n
        if self.family not in ("ssm",):
            win = self.sliding_window or seq_len
            ctx = min(seq_len, win)
            f += 4.0 * self.num_layers * self.num_heads * self.resolved_head_dim * ctx
        return f


@dataclass(frozen=True)
class SiteConfig(ModelConfig):
    """A hybrid with Zamba2's published shared blocks (Zamba2-7B).
    ``hybrid_layer_ids``: a site before each of these layers, its output
    added to that layer's norm input (not to the stream);
    ``num_mem_blocks`` blocks alternate over the sites; a site reads
    concat(x, input embedding) (``site_concat_input``), adds its own
    low-rank adapter of ``site_adapter_rank`` to the FFN's gate/up and
    ends in its own D x D ``site_linear``; ``attn_scale`` (0:
    1/sqrt(head_dim)) scales the scores.  A subclass, so that the
    reference's configs, which have none of these, convert field for
    field."""
    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 1
    site_concat_input: bool = False
    site_adapter_rank: int = 0
    site_linear: bool = False
    attn_scale: float = 0.0
