"""The port's kernels on the CPU: their plain versions against the reference
package's Pallas kernels (run in interpret mode) and its jnp oracles.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them to these same plain versions there.  Inputs come from numpy with
a seed and are handed to both packages.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

REPO = os.path.join(os.path.dirname(__file__), "..")


def _bf16_pair(a):
    """One bf16 array for both packages (same bits)."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(
        torch.bfloat16)
    return j, t


@pytest.mark.parametrize("t,d,v", [(5, 64, 1024), (16, 96, 1000),
                                   (3, 64, 777)])
def test_exit_head_entropy_plain_matches_reference(t, d, v):
    """Aligned (1024) and unaligned (1000, 777) vocab: the reference pads
    the vocab with a -1e30 bias row, the port masks it.  Both compute in
    fp32 from the same bf16 inputs; only the summation order differs, so
    the entropies agree to 1e-4."""
    rs = np.random.RandomState(t + v)
    xj, xt = _bf16_pair(rs.randn(t, d))
    wj, wt = _bf16_pair(rs.randn(d, v) * 0.08)
    got = ops.exit_head_entropy(xt, wt).numpy()
    kernel = np.asarray(jops.exit_head_entropy(xj, wj, interpret=True))
    oracle = np.asarray(jref.exit_head_entropy_ref(xj, wj))
    np.testing.assert_allclose(got, kernel, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


def _paged_inputs(seed, b=3, nq=8, nkv=2, hd=64, n_pages=12, page=16,
                  pps=4, pos=(0, 17, 50)):
    """Ragged positions, a shuffled page table and sentinel entries
    (n_pages) past each row's last used page."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, 1, nq, hd)
    pk = rs.randn(n_pages, page, nkv, hd)
    pv = rs.randn(n_pages, page, nkv, hd)
    perm = rs.permutation(n_pages)
    tbl = np.full((b, pps), n_pages, np.int32)
    k = 0
    for i, p in enumerate(pos):
        used = p // page + 1
        tbl[i, :used] = perm[k:k + used]
        k += used
    return q, pk, pv, tbl, np.asarray(pos, np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_gqa_attention_plain_matches_reference(seed):
    """The port's gather-view plain version against the reference's Pallas
    kernel (interpret mode) and jnp oracle.  All three accumulate in fp32
    and round once to bf16, so they differ by at most one bf16 ulp of the
    output (|out| < 4 here: 2^-6 = 0.0156)."""
    q, pk, pv, tbl, pos = _paged_inputs(seed)
    qj, qt = _bf16_pair(q)
    kj, kt = _bf16_pair(pk)
    vj, vt = _bf16_pair(pv)
    got = ops.paged_gqa_attention(qt, kt, vt, torch.from_numpy(tbl),
                                  torch.from_numpy(pos)).float().numpy()
    kernel = np.asarray(jops.paged_gqa_attention(
        qj, kj, vj, jnp.asarray(tbl), jnp.asarray(pos), interpret=True),
        np.float32)
    oracle = np.asarray(jref.paged_gqa_attention_ref(
        qj, kj, vj, jnp.asarray(tbl), jnp.asarray(pos)), np.float32)
    np.testing.assert_allclose(got, kernel, rtol=0, atol=2 ** -6)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=2 ** -6)


def test_kernels_import_without_nvcc_or_triton():
    """Importing the kernel modules builds nothing and needs neither nvcc
    nor triton: a fresh interpreter with no toolkit on PATH imports them."""
    code = ("import sys, shutil\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.build\n"
            "assert shutil.which('nvcc') is None\n"
            "assert 'triton' not in sys.modules\n"
            "assert not repro_torch.kernels.build._LIBS\n")
    env = dict(os.environ, PATH="/nonexistent",
               PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_cpu_tensors_never_count_launches():
    """A CPU tensor takes the plain version and never touches a launch
    counter."""
    before = dict(ops.LAUNCHES)
    q, pk, pv, tbl, pos = _paged_inputs(3)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    ops.paged_gqa_attention(bf(q), bf(pk), bf(pv), torch.from_numpy(tbl),
                            torch.from_numpy(pos))
    ops.exit_head_entropy(bf(np.ones((2, 8))), bf(np.ones((8, 5))))
    assert ops.LAUNCHES == before


def test_mixed_devices_are_rejected():
    """A wrapper never guesses a device: CPU and non-CPU tensors together
    raise."""
    x = torch.zeros(2, 8, dtype=torch.bfloat16)
    w = torch.zeros(8, 5, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        ops.exit_head_entropy(x, w)
