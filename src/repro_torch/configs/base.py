"""Model configuration for the PyTorch port.

A copy of the reference package's ``configs/base.py`` dataclasses, trimmed
to what the ported decode path reads.  Field names, defaults and the
``reduced()`` smoke derivation are kept identical, so a config built here
describes the same model as the reference config of the same name.
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
    act: str = "silu"              # silu | gelu
    tie_embeddings: bool = False
    mtp_depth: int = 0
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

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
