"""The Model: plan-driven transformer with early exits (dense, MoE, hybrid
Mamba2, xLSTM, vision-language and encoder-decoder families, GQA or MLA
attention; the xLSTM family has no attention and no RoPE).

Public surface, as in the reference:

    m = Model(config, device="cuda")
    params  = m.init(seed)
    out     = m.forward(params, {"tokens": tokens})     # ModelOutputs
    cache   = m.init_decode_cache(batch, cache_len)
    logits, ee, cache = m.decode_step(params, cache, tokens, position)

Batch keys: "tokens" [B, S] int (always); "patch_embeds" [B, Tf, D]
(vlm: the first Tf positions take them, under M-RoPE's (t, h, w) patch
grid); "frames" [B, Tenc, D] (encdec: the encoder's input); "positions"
optional.  ``forward`` runs the full sequence at once; its GQA attention
(causal self-attention, the encoder's unmasked self-attention and the
decoder's cross-attention) goes through the flash-attention kernel on the
card.

Depth-segmented decode: the plan compiles into ``decode_segments`` — runs of
plan steps bounded by exit heads.  The serving scheduler runs only the
segments each token still needs:

    x          = m.embed_decode_tokens(params, tokens)
    x, cache   = m.decode_segment(params, cache, x, seg, pos, alive)
    entropy    = m.exit_probe_entropy(params, seg.exit_index, x)  # kernel
    logits     = m.finalize_decode(params, x)

A Zamba2 model with published sites (``cfg.hybrid_layer_ids``) also hands
``decode_segment`` the token embeddings (``emb=``), which every site reads
beside the stream.  Each plan step of an eager step or forward opens a
``repro.model.<kind>`` span while a profiler collects
(``common.step_span``).

``alive`` [B] gates per-slot work: an exited slot's hidden state is frozen
(passthrough) and its KV and state rows are not written; every slot's
token comes from ``finalize_decode`` over its possibly early-frozen hidden
state.

Decode caches are updated in place (the reference donates them); the
functions still return them so call sites read like the reference's.
Params are plain nested dicts of tensors with the reference's tree layout,
so ``bridge.params_from_jax`` maps one onto the other leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import blocks as B
from repro_torch.models.ffn import SINGLE, ShardCtx
from repro_torch.models.common import (Leaf, apply_norm, embed, init_norm,
                                       materialize, normal_init,
                                       resolve_device, step_span, tree_map,
                                       unembed)


@dataclasses.dataclass
class ModelOutputs:
    logits: torch.Tensor                  # [B,S,V] fp32
    exit_logits: List[torch.Tensor]       # per exit head, [B,S,V] fp32
    aux_loss: torch.Tensor                # MoE load-balance scalar
    hidden: torch.Tensor                  # final (normed) hidden [B,S,D]
    mtp_logits: Optional[torch.Tensor] = None  # [B,S,V] (predicts t+2)


@dataclasses.dataclass(frozen=True)
class DepthSegment:
    """A run of plan steps bounded by exit heads (see the reference)."""
    index: int
    steps: Tuple[Tuple, ...]
    exit_index: Optional[int]
    layers: int
    layer_frac: float              # layers / num_layers


def _entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def _row_where(mask, axis):
    """Per-leaf row select: ``new`` where ``mask`` along ``axis``."""
    def f(new, old):
        shape = [1] * new.ndim
        shape[axis] = -1
        return torch.where(mask.reshape(shape), new, old)
    return f


class Model:
    def __init__(self, cfg, device="cuda", ctx: ShardCtx = SINGLE):
        """``ctx``: the mesh of the expert-parallel MoE layers
        (``ShardCtx(device_mesh)``; their params then hold each rank's
        experts only, ``ffn.local_experts``), or ``SINGLE`` for one
        device, as serving and training run."""
        self.cfg = cfg
        self.ctx = ctx
        self.device = resolve_device(device)
        self.plan = B.build_plan(cfg)
        self.n_exits = sum(1 for s in self.plan if s[0] == "exit")
        self.decode_segments = self._build_decode_segments()

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    def init(self, seed: int = 0, keep=None) -> Dict[str, Any]:
        """Random params from a seeded ``torch.Generator`` on the model's
        device, with the reference's tree and distributions: embed
        N(0, 0.02), matmul weights N(0, 1/fan_in), bf16 for rank >= 2
        after stacking, fp32 otherwise.  Every tensor is made in place in
        its final dtype (``common.materialize``).

        ``keep(part)`` (None: every part) picks the parts this process
        holds: "embed", "lm_head", "final_norm", "shared_attn",
        "exit_heads", "encoder", "enc_norm", "mtp", and ("blocks", i) for
        scan block i.  A part not kept is left out of the tree (a block
        becomes None in ``params["blocks"]``); its draws are made and
        dropped, so every kept part equals the full init's."""
        return self._init(torch.Generator(device=self.device)
                          .manual_seed(seed), self.device, keep)

    def abstract_params(self) -> Dict[str, Any]:
        """The params tree on the "meta" device: every leaf's shape and
        dtype, no storage and no draws (what the partition rules read)."""
        return self._init(None, torch.device("meta"), None)

    def _init(self, gen, dev, keep):
        cfg = self.cfg

        def part(name, fn):
            if keep is None or keep(name):
                return fn(True)
            fn(False)                         # draw and drop
            return None
        top = {"embed": normal_init((cfg.vocab_size, cfg.d_model), 0.02),
               "final_norm": init_norm(cfg.norm, cfg.d_model)}
        if not cfg.tie_embeddings:
            top["lm_head"] = normal_init((cfg.vocab_size, cfg.d_model), 0.02)
        params: Dict[str, Any] = {}
        for name, leaf in top.items():
            params[name] = part(name, lambda k, leaf=leaf: materialize(
                gen, leaf, dev, keep=k))
        params["blocks"] = [
            part(("blocks", bi), lambda k, kind=kind, n=n: B.init_scan_block(
                gen, cfg, kind, n, dev, keep=k))
            for bi, (_, kind, n, _) in enumerate(
                s for s in self.plan if s[0] == "scan")]
        if cfg.hybrid_layer_ids:
            params["shared_attn"] = part("shared_attn", lambda k: materialize(
                gen, B.init_sites(cfg), dev, keep=k))
        elif cfg.shared_attn_period:
            params["shared_attn"] = part("shared_attn", lambda k: materialize(
                gen, B.init_shared_attn(cfg), dev, keep=k))
        if self.n_exits:
            params["exit_heads"] = part("exit_heads", lambda k: [
                materialize(gen, B.init_exit_head(cfg), dev, keep=k)
                for _ in range(self.n_exits)])
        if cfg.family == "encdec":
            params["encoder"] = part("encoder", lambda k: B.init_scan_block(
                gen, cfg, "enc", cfg.encdec.num_encoder_layers, dev, keep=k))
            params["enc_norm"] = part("enc_norm", lambda k: materialize(
                gen, init_norm(cfg.norm, cfg.d_model), dev, keep=k))
        if cfg.mtp_depth:
            params["mtp"] = part("mtp", lambda k: self._init_mtp(gen, dev, k))
        return {k: v for k, v in params.items() if v is not None}

    def _init_mtp(self, gen, dev, keep=True):
        """DeepSeek-V3's multi-token-prediction head, as the reference
        builds it.  It feeds ``forward`` (``mtp_logits``), never decode."""
        cfg = self.cfg
        kind = "moe" if cfg.family == "moe" and cfg.moe.num_experts \
            else "dense"
        mtp = materialize(gen, {
            "combine": normal_init((2 * cfg.d_model, cfg.d_model), 0.02),
            "norm": init_norm(cfg.norm, cfg.d_model),
            "kind_is_moe": Leaf((), fill=float(kind == "moe"))}, dev,
            keep=keep)
        mtp["layer"] = B.init_scan_block(gen, cfg, kind, 1, dev, keep=keep)
        return mtp

    # ------------------------------------------------------------------
    # Forward (full sequence)
    # ------------------------------------------------------------------
    def positions_for(self, batch_size: int, seq_len: int,
                      frontend_tokens: int = 0, offset=0):
        """Positions of a full sequence: [B, S] int32 (RoPE and none), or
        [3, B, S] (t, h, w) under M-RoPE.  M-RoPE gives the first
        ``frontend_tokens`` positions (the patches) t = 0 and h, w on a
        g x g grid, g = ceil(sqrt(tf)); text continues at g + idx - tf in
        all three components; ``offset`` is added to every component.
        Copied from the reference as it is: with no patches g is 1, so
        text-only forward positions start at 1 where decode positions
        start at 0 (M-RoPE with equal components is RoPE, relative, so
        the scores agree up to rounding)."""
        dev = self.device
        base = torch.arange(seq_len, dtype=torch.int32, device=dev) + offset
        if self.cfg.rope != "mrope":
            return base[None].expand(batch_size, seq_len)
        tf = min(frontend_tokens, seq_len)
        g = int(math.ceil(math.sqrt(max(tf, 1))))
        idx = torch.arange(seq_len, dtype=torch.int32, device=dev)
        is_text = idx >= tf
        text = g + idx - tf
        t = torch.where(is_text, text, torch.zeros_like(idx))
        h = torch.where(is_text, text, idx // max(g, 1))
        w = torch.where(is_text, text, idx % max(g, 1))
        pos3 = torch.stack([t, h, w]) + offset             # [3, S]
        return pos3[:, None].expand(3, batch_size, seq_len)

    def frontend_tokens_of(self, batch) -> int:
        """Tf: the patch positions of a vlm batch (0 otherwise)."""
        if self.cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            return batch["patch_embeds"].shape[1]
        return 0

    def embed_inputs(self, params, batch):
        """Token embeddings [B, S, D]; a vlm batch's first Tf rows take its
        patch embeddings, cast to the embedding dtype."""
        x = embed(batch["tokens"], params["embed"])
        tf = self.frontend_tokens_of(batch)
        if tf:
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x[:, tf:]],
                          dim=1)
        return x

    def encode(self, params, frames):
        """Whisper's encoder over stub frame embeddings [B, Tenc, D]: its
        dense layers with unmasked self-attention, then its norm."""
        cfg = self.cfg
        pos = self.positions_for(frames.shape[0], frames.shape[1])
        x, _ = B.run_scan_block(cfg, "enc", params["encoder"], frames, pos, 0)
        return apply_norm(cfg.norm, x, params["enc_norm"])

    def forward(self, params, batch, *,
                long_mode: bool = False) -> ModelOutputs:
        """Full-sequence forward of ``batch`` (see the module docstring
        for its keys): final logits, every exit head's logits, the MoE aux
        loss, the final hidden state and, with an MTP head, the MTP
        logits.  An encdec model encodes ``batch["frames"]`` first and
        every decoder layer attends to it."""
        cfg = self.cfg
        x = self.embed_inputs(params, batch)
        bsz, seq = batch["tokens"].shape
        window = self._window(long_mode)
        positions = batch.get("positions")
        if positions is None:
            positions = self.positions_for(bsz, seq,
                                           self.frontend_tokens_of(batch))
        enc_out = None
        if cfg.family == "encdec":
            enc_out = self.encode(params, batch["frames"])
        x, aux, exit_logits = self.run_plan(params, x, positions, window,
                                            enc_out=enc_out)
        with step_span("head"):
            h = apply_norm(cfg.norm, x, params["final_norm"])
            logits = unembed(h, params.get("lm_head", params["embed"]))
        mtp_logits = None
        if cfg.mtp_depth and "mtp" in params:
            mtp_logits = self._mtp_forward(params, h, batch, positions,
                                           window)
        return ModelOutputs(logits, exit_logits, aux, h, mtp_logits)

    def run_plan(self, params, x, positions, window, alive=None,
                 enc_out=None, emb=None):
        """The plan's blocks and exit heads over the full sequence x
        [B, S, D].  ``alive`` [n_blocks] (bool or float; None = all
        alive) makes a failed block an identity bypass, x = a * y +
        (1 - a) * x, as ``core.resilience.resilient_forward`` asks; a
        shared-attention site follows the block before it.  ``enc_out``
        [B, Tenc, D] is what the decoder layers of an encdec model attend
        to; ``emb`` [B, S, D] the input embeddings Zamba2's published
        sites read (default: x as given).  Returns (x, aux loss, exit
        logits)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        exit_logits: List[torch.Tensor] = []
        emb = x if emb is None else emb
        inject = None
        bi = 0
        for step in self.plan:
            if step[0] == "scan":
                with step_span(step[1]):
                    y, a = B.run_scan_block(cfg, step[1],
                                            params["blocks"][bi], x,
                                            positions, window, enc_out,
                                            self.ctx, inject)
                inject = None
                if alive is None:
                    x = y
                else:
                    keep = alive[bi].to(y.dtype)
                    x = keep * y + (1.0 - keep) * x
                aux = aux + a
                bi += 1
            elif step[0] == "shared_attn" and cfg.hybrid_layer_ids:
                with step_span("site"):
                    inject = B.run_site(cfg, params["shared_attn"], step[1],
                                        x, emb, positions, window)
            elif step[0] == "shared_attn":
                y = B.run_shared_attn(cfg, params["shared_attn"], x,
                                      positions, window)
                if alive is None or bi == 0:
                    x = y
                else:
                    keep = alive[bi - 1].to(y.dtype)
                    x = keep * y + (1.0 - keep) * x
            else:
                with step_span("exit"):
                    exit_logits.append(B.exit_head_logits(
                        cfg, params["exit_heads"][step[1]], x))
        return x, aux, exit_logits

    def _mtp_forward(self, params, h, batch, positions, window):
        """DeepSeek-V3 MTP: combine the final hidden state with the next
        token's embedding and run one extra block to predict token t+2.
        The last position wraps around to the first token's embedding, as
        the reference's ``roll`` does."""
        cfg = self.cfg
        mp = params["mtp"]
        emb_next = torch.roll(embed(batch["tokens"], params["embed"]), -1,
                              dims=1)
        x = torch.matmul(torch.cat([h, emb_next], dim=-1),
                         mp["combine"].to(h.dtype))
        kind = "moe" if cfg.family == "moe" and cfg.moe.num_experts \
            else "dense"
        x, _ = B.run_scan_block(cfg, kind, mp["layer"], x, positions, window,
                                ctx=self.ctx)
        x = apply_norm(cfg.norm, x, mp["norm"])
        return unembed(x, params.get("lm_head", params["embed"]))

    # ------------------------------------------------------------------
    # Decode caches
    # ------------------------------------------------------------------
    def _window(self, long_mode: bool) -> int:
        cfg = self.cfg
        if cfg.attention == "sliding":
            return cfg.sliding_window
        if long_mode:
            return cfg.long_context_window
        return 0

    def cache_len_for(self, seq_len: int, long_mode: bool) -> int:
        w = self._window(long_mode)
        return min(seq_len, w) if w else seq_len

    def _stack(self, per):
        return tree_map(lambda *xs: torch.stack(xs), *per)

    def _shared_attn_cache(self, lead, dev):
        """One (k, v) pair a shared-attention site, [*lead, Nkv, H] bf16
        (the sites are unstacked)."""
        cfg = self.cfg
        shape = (*lead, cfg.num_kv_heads, cfg.resolved_head_dim)
        return [tuple(torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                      for _ in range(2))
                for _ in B.shared_attn_sites(cfg)]

    def init_decode_cache(self, batch_size: int, seq_len: int, *,
                          long_mode: bool = False, device=None):
        """Contiguous cache: per block, (k, v) [n_layers, B, S, Nkv, H] (a
        mamba block's state rows [n_layers, B, ...]; a decx block's
        {"cross": (k, v) [n_layers, B, Tenc, Nkv, H], "self": (k, v)}), plus
        (k, v)
        [B, S, Nkv, H] per shared-attention site, on the model's device
        unless ``device`` names another (the scheduler probes slot-row
        shapes on ``"meta"``)."""
        clen = self.cache_len_for(seq_len, long_mode)
        dev = self.device if device is None else device
        cache = {"blocks": [
            self._stack([B.init_layer_cache(self.cfg, kind, batch_size, clen,
                                            dev) for _ in range(n)])
            for _, kind, n, _ in (s for s in self.plan if s[0] == "scan")]}
        if B.shared_attn_sites(self.cfg):
            cache["shared_attn"] = self._shared_attn_cache(
                (batch_size, clen), dev)
        return cache

    def scan_block_kinds(self) -> List[str]:
        """Kind of each stacked block, in ``cache["blocks"]`` order."""
        return [s[1] for s in self.plan if s[0] == "scan"]

    def all_cache_paged(self) -> bool:
        """True iff every decode-cache leaf is pool-backed in paged mode
        (no sequential SSM/xLSTM state rows): a position-indexed cache
        whose rows past a rejected speculation are simply overwritten, and
        the only kind whose shared prefix pages determine a skipped
        replay."""
        return all(k in B.PAGED_KINDS for k in self.scan_block_kinds())

    def init_decode_cache_paged(self, batch_size: int, n_pages: int,
                                page_size: int, *, device=None):
        """Paged cache: per block, (k, v) pools
        [n_layers, n_pages, P, Nkv, H]; slots address them through the
        scheduler's block table, not a batch axis.  Mamba blocks keep
        their per-slot state rows [n_layers, B, ...]; shared-attention
        sites get unstacked pools [n_pages, P, Nkv, H]."""
        if self.cfg.family == "encdec":
            raise ValueError("paged decode: encdec unsupported")
        dev = self.device if device is None else device
        cache = {"blocks": [
            self._stack([B.init_layer_cache_paged(
                self.cfg, kind, batch_size, n_pages, page_size, dev)
                for _ in range(n)])
            for _, kind, n, _ in (s for s in self.plan if s[0] == "scan")]}
        if B.shared_attn_sites(self.cfg):
            cache["shared_attn"] = self._shared_attn_cache(
                (n_pages, page_size), dev)
        return cache

    def merge_decode_cache(self, take_new, new_cache, old_cache):
        """Row-wise merge of contiguous caches: slot b takes ``new_cache``
        where take_new[b].  Block caches are stacked [n_layers, B, ...]
        (batch axis 1), shared-attention caches are [B, ...] (batch axis
        0); ``old_cache`` is overwritten in place.  (Paged arenas need no
        merge: pool and state writes are gated per row inside the step.)"""
        for new, old in zip(new_cache["blocks"], old_cache["blocks"]):
            tree_map(lambda n, o: o.copy_(_row_where(take_new, 1)(n, o)),
                     new, old)
        for new, old in zip(new_cache.get("shared_attn", []),
                            old_cache.get("shared_attn", [])):
            tree_map(lambda n, o: o.copy_(_row_where(take_new, 0)(n, o)),
                     new, old)
        return old_cache

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def decode_step(self, params, cache, tokens, position, *,
                    long_mode: bool = False, paged=None, write_mask=None):
        """tokens [B,1] int; position [] or [B] int (per-slot positions).

        ``paged`` (an ``attention.PagedKV``): attention caches are paged
        pools addressed through its block table, writes (and the state
        rows' stores) gated by its write_mask.  ``write_mask`` [B] gates
        contiguous-row writes (None = every row writes, as in the
        reference step).

        Returns (logits [B,V] fp32, exit_entropies [n_exits,B] fp32, cache).
        """
        cfg = self.cfg
        x = emb = embed(tokens, params["embed"])
        window = self._window(long_mode)
        exit_entropies = []
        inject = None
        bi = 0
        for step in self.plan:
            if step[0] == "scan":
                with step_span(step[1]):
                    x, _ = B.decode_scan_block(
                        cfg, step[1], params["blocks"][bi], x,
                        cache["blocks"][bi], position, window, paged,
                        write_mask, self.ctx, inject)
                inject = None
                bi += 1
            elif step[0] == "shared_attn":
                with step_span("site"):
                    x, inject = self._decode_site(
                        params, cache, step[1], x, emb, position, window,
                        paged, write_mask)
            elif step[0] == "exit":
                with step_span("exit"):
                    lg = B.exit_head_logits(
                        cfg, params["exit_heads"][step[1]], x)[:, 0]
                    exit_entropies.append(_entropy(lg))
        logits = self.finalize_decode(params, x)
        ee = (torch.stack(exit_entropies) if exit_entropies
              else torch.zeros((0, tokens.shape[0]), dtype=torch.float32,
                               device=x.device))
        return logits, ee, cache

    def _decode_site(self, params, cache, k, x, emb, position, window,
                     paged, write_mask):
        """Shared-attention site k at one token: (x, what it adds to the
        next layer's norm input).  The period layout updates x and adds
        nothing; Zamba2's published sites leave x and return their
        output."""
        cfg = self.cfg
        if not cfg.hybrid_layer_ids:
            x, _ = B.run_shared_attn_decode(
                cfg, params["shared_attn"], x, cache["shared_attn"][k],
                position, window, paged, write_mask)
            return x, None
        if emb is None:
            raise ValueError("decode: Zamba2's sites read the token "
                             "embeddings; pass emb=")
        return x, B.run_site_decode(cfg, params["shared_attn"], k, x, emb,
                                    cache["shared_attn"][k], position,
                                    window, paged, write_mask)

    def _build_decode_segments(self) -> List[DepthSegment]:
        """Split the plan at exit heads into index-resolved depth segments."""
        cfg = self.cfg
        total = max(1, cfg.num_layers)
        segs: List[DepthSegment] = []
        steps: List[Tuple] = []
        layers = 0
        bi = sa_i = 0
        for step in self.plan:
            if step[0] == "scan":
                _, kind, n, _ = step
                steps.append(("scan", kind, bi))
                bi += 1
                per_unit = cfg.moe.layer_period if kind == "pair" else 1
                layers += n * per_unit
            elif step[0] == "shared_attn":
                steps.append(("shared_attn", sa_i))
                sa_i += 1
            elif step[0] == "exit":
                segs.append(DepthSegment(len(segs), tuple(steps), step[1],
                                         layers, layers / total))
                steps, layers = [], 0
        segs.append(DepthSegment(len(segs), tuple(steps), None,
                                 layers, layers / total))
        return segs

    def embed_decode_tokens(self, params, tokens):
        """tokens [B,1] int -> embeddings [B,1,D]."""
        return embed(tokens, params["embed"])

    def decode_segment(self, params, cache, x, seg: DepthSegment, position,
                       alive, *, long_mode: bool = False, paged=None,
                       passthrough=None, emb=None):
        """One-token decode through one depth segment.

        ``alive`` [B] bool gates cache writes (contiguous rows here; paged
        pools and state rows through ``paged.write_mask``, which the
        caller sets).  ``passthrough`` (default ``alive``) selects which
        rows take the segment's hidden output; the others keep ``x``.
        With ``alive`` all-true this is exactly the matching slice of
        ``decode_step``.  ``emb`` [B, 1, D]: the token embeddings, which
        Zamba2's published sites read.
        """
        window = self._window(long_mode)
        x_in = x
        if passthrough is None:
            passthrough = alive
        wm = None if paged is not None else alive
        inject = None
        for st in seg.steps:
            if st[0] == "scan":
                _, kind, bi = st
                with step_span(kind):
                    x, _ = B.decode_scan_block(
                        self.cfg, kind, params["blocks"][bi], x,
                        cache["blocks"][bi], position, window, paged, wm,
                        self.ctx, inject)
                inject = None
            else:
                with step_span("site"):
                    x, inject = self._decode_site(params, cache, st[1], x,
                                                  emb, position, window,
                                                  paged, wm)
        x = torch.where(passthrough[:, None, None], x, x_in)
        return x, cache

    def exit_probe_entropy(self, params, exit_index: int, x):
        """Entropy of exit head ``exit_index`` over decode hidden x [B,1,D],
        through the fused exit-head kernel: the [B,V] exit logits are never
        stored."""
        p = params["exit_heads"][exit_index]
        with step_span("exit"):
            h = B.exit_head_hidden(self.cfg, p, x[:, 0, :])
            return kops.exit_head_entropy(h, p["w"])

    def finalize_decode(self, params, x):
        """Final norm + LM head over decode hidden x [B,1,D] -> [B,V] fp32."""
        with step_span("head"):
            h = apply_norm(self.cfg.norm, x, params["final_norm"])
            return unembed(h, params.get("lm_head", params["embed"]))[:, 0]

    # ------------------------------------------------------------------
    def prefill(self, params, batch, *, long_mode: bool = False):
        """Build a decode cache from the prompt by replaying its tokens
        through ``decode_step`` (as the reference does).  Returns (logits
        [B,S,V] fp32, cache)."""
        tokens = batch["tokens"]
        bsz, seq = tokens.shape
        cache = self.init_decode_cache(bsz, seq, long_mode=long_mode)
        all_logits = []
        for t in range(seq):
            logits, _, cache = self.decode_step(
                params, cache, tokens[:, t:t + 1], t, long_mode=long_mode)
            all_logits.append(logits)
        return torch.stack(all_logits, dim=1), cache
