"""``REPRO_ATTN`` and the chunked attention path of the port against the
reference, on the CPU.

``_sdpa_chunked`` (q chunks, kv chunks folded in with an online softmax,
bf16 block inputs, fp32 statistics) is held against the reference's at
the three cases of the reference's own
``test_chunked_attention_matches_dense`` (2e-2, its tolerance).  The
toggle is read once, at import, so every test that sets it runs in a
subprocess: nothing is reloaded in this process.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _sdpa_chunked as ref_chunked
from repro_torch.models import attention
from repro_torch.models.attention import _sdpa_chunked

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ATOL = 2e-2


def _qkv(b, sq, skv, nq, nkv, h, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((b, sq, nq, h)).astype(np.float32),
            rs.standard_normal((b, skv, nkv, h)).astype(np.float32),
            rs.standard_normal((b, skv, nkv, h)).astype(np.float32))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 300),
                                           (False, 0)])
def test_chunked_matches_reference(causal, window):
    q, k, v = _qkv(1, 2048, 2048, 4, 2, 16)
    kw = dict(causal=causal, window=window, scale=1 / 16 ** 0.5,
              q_chunk=512, kv_chunk=512)
    want = ref_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = _sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=ATOL, atol=ATOL)


def test_chunked_matches_dense_plain_version():
    """The chunked path against the flash kernel's plain version (the
    dense default) in bf16, GQA with G 3, causal and windowed."""
    from repro_torch.kernels import ref
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(2, 1024, 1024, 6, 2, 32, seed=1))
    for window in (0, 200):
        want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        got = _sdpa_chunked(q, k, v, causal=True, window=window,
                            scale=1 / 32 ** 0.5, q_chunk=256, kv_chunk=256)
        assert got.dtype == torch.bfloat16
        assert (got.float() - want.float()).abs().max().item() <= ATOL


def test_chunked_refuses_partial_chunks():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1000, 1000, 2, 2, 8))
    with pytest.raises(ValueError, match="whole chunks"):
        _sdpa_chunked(q, k, v, causal=True, window=0, scale=1.0,
                      q_chunk=512, kv_chunk=512)


def test_default_is_dense():
    assert os.environ.get("REPRO_ATTN") is None
    assert attention.ATTN_IMPL == "dense"
    q = torch.zeros(1, 4096, 2, 8)
    assert not attention._takes_chunked(q, q)


def _run(code, **env):
    e = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **env)
    return subprocess.run([sys.executable, "-c", code], env=e,
                          capture_output=True, text=True, timeout=300)


def test_unknown_value_raises_at_import():
    out = _run("import repro_torch.models.attention", REPRO_ATTN="kernal")
    assert out.returncode != 0
    assert "ValueError" in out.stderr
    assert "REPRO_ATTN='kernal' is not a known implementation" in out.stderr
    assert "'dense', 'chunked'" in out.stderr
    ok = _run("import repro_torch.models.attention as a; print(a.ATTN_IMPL)",
              REPRO_ATTN="dense")
    assert ok.returncode == 0 and ok.stdout.split() == ["dense"]


_GQA = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np, torch
from repro.configs import get_config as ref_config
from repro.models import attention as ra
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as ta
torch.set_num_threads(1)
cfg = get_config("llama4-maverick-400b-a17b-smoke")
rcfg = ref_config("llama4-maverick-400b-a17b-smoke")
rp = ra.init_gqa(jax.random.PRNGKey(0), rcfg)
tp = params_from_jax(jax.tree.map(np.asarray, rp))
calls = []
real = ta._sdpa_chunked
def rec(*a, **kw):
    calls.append(a[0].shape[1])
    return real(*a, **kw)
ta._sdpa_chunked = rec
flash = []
real_flash = ops.flash_attention
def rec_flash(q, *a, **kw):
    flash.append(q.shape[1])
    return real_flash(q, *a, **kw)
ops.flash_attention = rec_flash
out = {"impl": ta.ATTN_IMPL, "err": {}}
rs = np.random.RandomState(0)
for s in (3072, 1024, 1536):
    x = (0.5 * rs.standard_normal((1, s, cfg.d_model))).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    want, _ = ra.gqa_forward(rcfg, rp, jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(pos), window=0)
    got, _ = ta.gqa_forward(cfg, tp, torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(pos), window=0)
    out["err"][s] = float(np.abs(got.float().numpy()
                                 - np.asarray(want, np.float32)).max())
kv = torch.from_numpy((0.5 * rs.standard_normal((1, 3072, cfg.d_model))
                       ).astype(np.float32)).bfloat16()
ta.gqa_forward(cfg, tp, kv, None, kv_x=kv)
out["chunked"], out["flash"] = calls, flash
print(json.dumps(out))
"""


@pytest.mark.parametrize("impl", ["chunked", "dense"])
def test_gqa_forward_takes_chunked_where_the_reference_does(impl):
    """Under each setting, in a subprocess, both packages' ``gqa_forward``
    on the same llama4-smoke attention weights: the port takes
    ``_sdpa_chunked`` exactly where the reference does (self-attention,
    Sq * Skv above 2048^2, lengths multiples of 1024: 3072 tokens, not
    1024 nor 1536, never cross-attention) and the flash wrapper
    everywhere else; outputs within 2e-2 of the reference's."""
    import json
    out = _run(_GQA, REPRO_ATTN=impl, JAX_PLATFORMS="cpu")
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["impl"] == impl
    if impl == "chunked":
        assert res["chunked"] == [3072]
        assert res["flash"] == [1024, 1536, 3072]
    else:
        assert res["chunked"] == []
        assert res["flash"] == [3072, 1024, 1536, 3072]
    assert max(res["err"].values()) <= ATOL, res["err"]
