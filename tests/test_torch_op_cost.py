"""``launch.op_cost``, the port's counterpart of the reference's
``launch/hlo_cost.py``, against it.

Flops, exactly: the port's ``Model.forward`` (every output) and its serve
step, counted on "meta" and on the CPU, against ``hlo_cost.analyze`` of
the reference's compiled forward with every field of ``ModelOutputs``
returned (XLA drops the exit and MTP heads of a program that returns
only the logits) and of its compiled serve step, on granite-3-2b-smoke
and deepseek-v3-671b-smoke at 2 x 32.  The analogues of the reference's
analyzer invariants (``tests/test_perf_features.py``): a loop of 7
products counts 7 x 2 x 64^3 exactly, and a stacked buffer written a
row a step counts the rows, well under half the buffer a step.  Every
kernel wrapper gives the same flops and bytes on "cpu" and "meta", its
formulas', and hides its plain version.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch.hlo_cost import analyze as hlo_analyze
from repro.models import Model as RefModel
from repro.serving.engine import make_serve_step as ref_serve_step
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.op_cost import analyze, tensor_bytes
from repro_torch.models import Model
from repro_torch.serving.engine import make_serve_step

B, S = 2, 32
ARCHS = ["granite-3-2b-smoke", "deepseek-v3-671b-smoke"]
# what both sides count at 2 x 32 (the reference's hlo_cost, checked
# below): forward, decode step
FLOPS = {"granite-3-2b-smoke": (239075328.0, 7471104.0),
         "deepseek-v3-671b-smoke": (291504128.0, 7950336.0)}


@pytest.fixture(scope="module")
def ref_flops():
    out = {}
    for arch in ARCHS:
        rm = RefModel(ref_config(arch))
        p = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
        b = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
        fwd = jax.jit(lambda p, b: dataclasses.astuple(rm.forward(p, b))
                      ).lower(p, b).compile().as_text()
        cache = jax.eval_shape(lambda: rm.init_decode_cache(B, S))
        dec = jax.jit(ref_serve_step(rm)).lower(
            p, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32)).compile().as_text()
        out[arch] = (hlo_analyze(fwd).flops, hlo_analyze(dec).flops)
    return out


def test_reference_counts(ref_flops):
    assert ref_flops == FLOPS


@pytest.mark.parametrize("dev", ["meta", "cpu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_flops_equal_the_references(arch, dev):
    model = Model(get_config(arch), device=dev)
    params = model.abstract_params() if dev == "meta" else model.init(0)
    tokens = torch.zeros((B, S), dtype=torch.int32, device=dev)
    with torch.no_grad():
        fwd = analyze(model.forward, params, {"tokens": tokens})
        cache = model.init_decode_cache(B, S, device=dev)
        dec = analyze(make_serve_step(model), params, cache, tokens[:, :1],
                      torch.full((), S - 1, dtype=torch.int32, device=dev))
    assert (fwd.flops, dec.flops) == FLOPS[arch]
    assert fwd.bytes > 0 and dec.bytes > 0
    assert fwd.collective == {k: 0.0 for k in fwd.collective}
    assert not fwd.top_collective()


def test_a_loop_of_products_counts_every_trip():
    """The scan analogue: 7 products of 64 x 64 in a Python loop."""
    x = torch.randn(64, 64)
    w = torch.randn(7, 64, 64)

    def f(x, w):
        for i in range(7):
            x = torch.tanh(x @ w[i])
        return x
    c = analyze(f, x, w)
    assert c.flops == 7 * 2 * 64 ** 3
    # each trip: the product reads x and w[i] and writes x, tanh reads and
    # writes it; w[i] is a view (free)
    assert c.bytes == 7 * 5 * 64 * 64 * 4


@pytest.mark.parametrize("dev", ["meta", "cpu"])
def test_a_stacked_buffer_counts_its_rows(dev):
    """The dynamic-update-slice analogue: a [T, 128, 128] buffer written
    a row a step (``copy_`` into a select view, ``index_copy_``,
    ``index_put_``) counts each written row and its source, never the
    whole buffer."""
    t = 100
    row = 128 * 128 * 4
    full_buffer_per_step = t * (t * row)

    def stack(x, how):
        out = torch.empty((t, 128, 128), device=x.device)
        for i in range(t):
            x = torch.tanh(x)
            if how == "copy_":
                out[i].copy_(x)
            elif how == "index_copy_":
                out.index_copy_(0, torch.tensor([i], device=x.device), x[None])
            else:
                out[torch.tensor([i], device=x.device)] = x[None]
        return out

    x = torch.empty((128, 128), device=dev)
    for how in ("copy_", "index_copy_", "index_put_"):
        c = analyze(stack, x, how)
        assert c.bytes < full_buffer_per_step * 0.5, how
        writes = [b for label, (b, _) in c.top.items()
                  if label.startswith(f"aten.{how}")
                  or label.startswith("aten._index_put_impl_")]
        per = sum(writes) / t
        assert 2 * row <= per < 2 * row + 64, (how, per)


def test_views_are_free_and_an_expand_reads_its_source():
    x = torch.randn(4, 8)
    c = analyze(lambda x: x.t().reshape(8, 4)[1:3].unsqueeze(0).detach(), x)
    assert c.bytes == 0 and c.flops == 0
    e = x[:, :1].expand(4, 8)
    assert tensor_bytes(e) == 4 * 4
    c = analyze(lambda e: e + 1.0, e)
    assert c.bytes == 4 * 4 + 4 * 8 * 4


def test_labels_name_the_op_and_the_ports_frame():
    model = Model(get_config("granite-3-2b-smoke"), device="meta")
    c = analyze(model.forward, model.abstract_params(),
                {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                       device="meta")})
    labels = [label for label, _ in c.top_bytes(30)]
    assert all(label.split()[0].startswith("aten.")
               or "(kernel)" in label for label in labels)
    assert all("repro_torch/" in label for label in labels), labels
    assert any("repro_torch/models/" in label for label in labels)
    kern = [label for label in c.top if "(kernel)" in label]
    assert kern and all(label.startswith("flash_attention (kernel)")
                        for label in kern)
    assert c.kernels["flash_attention"]["calls"] == 2


def _kernel_cases(dev):
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dtype).to(dev)
    q = rnd(2, 16, 4, 32)
    k, v = rnd(2, 16, 2, 32), rnd(2, 16, 2, 32)
    o = rnd(2, 16, 4, 32)
    lse = rnd(2, 4, 16, dtype=torch.float32)
    pool = rnd(6, 4, 2, 32)
    tbl = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32).to(dev)
    pos = torch.tensor([5, 9], dtype=torch.int32).to(dev)
    aq = torch.randint(-127, 128, (2, 3, 8), generator=g,
                       dtype=torch.int8).to(dev)
    wq = torch.randint(-127, 128, (2, 8, 4), generator=g,
                       dtype=torch.int8).to(dev)
    x8 = rnd(5, 64)
    qi = torch.zeros((5, 64), dtype=torch.int8).to(dev)
    sc = torch.ones((5, 1)).to(dev)
    return {
        "exit_head_entropy": (ops.exit_head_entropy,
                              (rnd(3, 32), rnd(32, 50)), {}),
        "flash_attention": (ops.flash_attention, (q, k, v), {}),
        "flash_attention_bwd": (ops.flash_attention_bwd,
                                (q, k, v, o, o, lse), {}),
        "paged_gqa_attention": (ops.paged_gqa_attention,
                                (rnd(2, 1, 4, 32), pool, pool, tbl, pos), {}),
        "paged_mla_attention": (ops.paged_mla_attention,
                                (rnd(2, 1, 4, 16), rnd(2, 1, 4, 8),
                                 rnd(6, 4, 16), rnd(6, 4, 8), tbl, pos),
                                {"scale": 0.2}),
        "quantize_rows": (ops.compress_rows, (x8,), {}),
        "dequantize_rows": (ops.decompress_rows, (qi, sc), {}),
        "w8a8_expert_matmul": (ops.w8a8_expert_matmul,
                               (aq, torch.ones(2, 3, 1).to(dev), wq,
                                torch.ones(2, 1, 4).to(dev)), {}),
    }


FORMULAS = {"exit_head_entropy": (ops.exit_head_flops, ops.exit_head_bytes),
            "flash_attention": (ops.flash_attention_flops,
                                ops.flash_attention_bytes),
            "flash_attention_bwd": (ops.flash_attention_bwd_flops,
                                    ops.flash_attention_bwd_bytes),
            "paged_gqa_attention": (ops.paged_gqa_flops, ops.paged_gqa_bytes),
            "paged_mla_attention": (ops.paged_mla_flops, ops.paged_mla_bytes),
            "quantize_rows": (None, ops.quantize_rows_bytes),
            "dequantize_rows": (None, ops.dequantize_rows_bytes),
            "w8a8_expert_matmul": (ops.w8a8_expert_flops,
                                   ops.w8a8_expert_bytes)}


@pytest.mark.parametrize("name", sorted(FORMULAS))
def test_kernel_wrappers_count_alike_on_cpu_and_meta(name):
    """One wrapper call under ``analyze``: only the kernel's formulas are
    counted (its plain version runs hidden), equal on both devices."""
    counted = {}
    for dev in ("cpu", "meta"):
        fn, args, kw = _kernel_cases(dev)[name]
        c = analyze(fn, *args, **kw)
        assert list(c.kernels) == [name]
        assert c.kernels[name]["calls"] == 1
        assert (c.flops, c.bytes) == (c.kernels[name]["flops"],
                                      c.kernels[name]["bytes"])
        flops_f, bytes_f = FORMULAS[name]
        assert c.flops == (flops_f(*args) if flops_f else 0.0)
        if name != "flash_attention":     # the forward writes no lse here
            assert c.bytes == bytes_f(*args, **kw)
        counted[dev] = (c.flops, c.bytes)
    assert counted["cpu"] == counted["meta"]
    assert counted["cpu"][1] > 0


def test_byte_formulas_by_hand():
    q = torch.empty(2, 16, 4, 32, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 16, 2, 32, dtype=torch.bfloat16, device="meta")
    qb, kb = q.numel() * 2, k.numel() * 2
    assert ops.flash_attention_bytes(q, k, k) == 2 * qb + 2 * kb
    assert ops.flash_attention_bytes(q, k, k, True, 0, with_lse=True) \
        == 2 * qb + 2 * kb + 4 * 2 * 4 * 16
    x = torch.empty(6, 10, device="meta")
    assert ops.quantize_rows_bytes(x) == 240 + 60 + 24
    qi = torch.empty(6, 10, dtype=torch.int8, device="meta")
    s = torch.empty(6, 1, device="meta")
    assert ops.dequantize_rows_bytes(qi, s) == 60 + 24 + 120
    assert ops.dequantize_rows_bytes(qi, s, torch.float32) == 60 + 24 + 240
    # a paged kernel reads every page of its table
    pool = torch.empty(9, 4, 2, 32, dtype=torch.bfloat16, device="meta")
    tbl = torch.empty(2, 3, dtype=torch.int32, device="meta")
    pos = torch.empty(2, dtype=torch.int32, device="meta")
    qd = torch.empty(2, 1, 4, 32, dtype=torch.bfloat16, device="meta")
    assert ops.paged_gqa_bytes(qd, pool, pool, tbl, pos) == (
        2 * qd.numel() * 2 + 24 + 8 + 2 * 6 * 4 * 2 * 32 * 2)


def test_counting_outside_analyze_is_off():
    x = torch.randn(3, 32).bfloat16()
    w = torch.randn(32, 50).bfloat16()
    assert ops._SINK is None
    seen = []
    with ops.count_costs(lambda *a: seen.append(a)):
        ops.exit_head_entropy(x, w)
        ops.compress_rows(x)
    assert ops._SINK is None
    assert [a[0] for a in seen] == ["exit_head_entropy", "quantize_rows"]
    assert seen[1][1] == 0.0 and seen[0][1] == ops.exit_head_flops(x, w)
    got = ops.exit_head_entropy(x, w)
    assert math.isfinite(float(got.sum()))
