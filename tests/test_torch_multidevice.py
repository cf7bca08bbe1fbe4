"""Collaborative execution over a world of ranks against the reference on
its placeholder devices: staged pod execution (``core.hierarchy``), the
expert-parallel MoE (``models.ffn.moe_ffn`` with a mesh) and a model
forward whose MoE layers run expert parallel.

Both sides run once, in two subprocesses started together: the reference
on 4 placeholder CPU devices (``--xla_force_host_platform_device_count``,
as ``tests/test_multidevice.py`` runs it), writing an ``.npz``; the port
in one gloo world of 4 ranks (``launch.mesh.run_world`` over
``launch.collab.run_jobs``, one intra-op thread a rank), each rank
writing what it got.  Same weights: the reference's init bridged.

Meshes: staged runs on (pod 2, data 2, model 1), stages [0, 1], so each
pod runs one scan block and each rank two of the four rows; the MoE and
the model forward on (data 2, model 2), each rank holding two of the four
experts.  The reference's staged_forward runs under ``jax.jit``: its
boundary then rounds as the port's int8 kernel does
(``tests/test_torch_offload.py``).

Tolerances: logits 2e-2 (``tests/test_torch_forward.py``'s); MoE y within
2e-2 of max(1, |ref|) and aux within 1e-3 (``PERF.md`` §2's W8A8 MoE
gate).  Exact: the port's staged raw logits against its own one-process
``Model.forward`` (bit for bit), the compressed boundary's (q, scale)
against the plain quantizer, every rank's output against rank 0's, and a
rank's seeded part (its stage's blocks, its experts) against the same
part of a full init.  Against the single-device ``moe_ffn_reference`` at
capacity factor 8.0 (no drops) y is held to the same 2e-2; its aux is the
load-balance loss of all tokens at once, which the sharded layer's mean of
per-shard losses is not (the reference's ``pmean``), so aux is held to the
mean of the single-device losses of the two data shards.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.models import ffn as ref_ffn
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model, ffn
from repro_torch.models.common import tree_map

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ATOL = 2e-2
MOE_TOL = 2e-2
AUX_TOL = 1e-3
ROUTE_TIE = 1e-2      # tests/test_torch_llama4.py's
STAGES = [0, 1]
GRANITE = "granite-3-2b-smoke"
ZAMBA = "zamba2-1.2b-smoke"
QWEN = "qwen2-vl-2b-smoke"
LLAMA = "llama4-maverick-400b-a17b-smoke"
CFS = {"cfg": None, "cf8": 8.0}

_REF = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.hierarchy import staged_forward
from repro.launch.roofline import collective_bytes_from_hlo
from repro.models import Model, ffn

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
for arch, key in (("granite-3-2b-smoke", "granite"),
                  ("zamba2-1.2b-smoke", "zamba2"),
                  ("qwen2-vl-2b-smoke", "qwen2_vl")):
    m = Model(get_config(arch))
    p = m.init(jax.random.PRNGKey(0))
    batch = {"tokens": jnp.asarray(inp[key + "_tokens"])}
    if key + "_patches" in inp:
        batch["patch_embeds"] = jnp.asarray(inp[key + "_patches"])
    for c in ((False, True) if key == "granite" else (False,)):
        f = jax.jit(lambda p, b, c=c: staged_forward(
            m, p, b, [0, 1], mesh, compress_boundary=c))
        out[key + ("_compressed" if c else "_raw")] = np.asarray(f(p, batch))

mesh2 = jax.make_mesh((2, 2), ("data", "model"))
base = get_config("llama4-maverick-400b-a17b-smoke")
m = Model(base)
p = m.init(jax.random.PRNGKey(0))
moe = jax.tree.map(lambda a: a[0], p["blocks"][0]["b"]["moe"])
x = jnp.asarray(inp["moe_x"], jnp.bfloat16)
with (jax.set_mesh(mesh2) if hasattr(jax, "set_mesh") else mesh2):
    for w8 in (False, True):
        mp = ffn.quantize_expert_weights(moe) if w8 else moe
        for cf_key, cf in (("cfg", None), ("cf8", 8.0)):
            cfg = base if cf is None else dataclasses.replace(
                base, moe=dataclasses.replace(base.moe, capacity_factor=cf))
            lowered = jax.jit(lambda p, x, cfg=cfg: ffn.moe_ffn(
                p, x, cfg, ffn.ShardCtx(mesh2))).lower(mp, x)
            compiled = lowered.compile()
            y, aux = compiled(mp, x)
            k = f"moe_{'w8a8' if w8 else 'bf16'}_{cf_key}"
            for stage, hlo in (("lowered", lowered.compiler_ir("hlo")
                                .as_hlo_text()),
                               ("compiled", compiled.as_text())):
                out[k + "_all_reduce_" + stage] = np.float64(
                    collective_bytes_from_hlo(hlo)["all-reduce"])
            out[k + "_y"] = np.asarray(y.astype(jnp.float32))
            out[k + "_aux"] = np.asarray(aux)
    cfg8 = dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, capacity_factor=8.0))
    mm = Model(cfg8, ctx=ffn.ShardCtx(mesh2))
    fwd = jax.jit(lambda p, b: (lambda o: (o.logits, o.aux_loss))(
        mm.forward(p, b)))
    logits, aux = fwd(p, {"tokens": jnp.asarray(inp["llama_tokens"])})
    out["forward_logits"] = np.asarray(logits)
    out["forward_aux"] = np.asarray(aux)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def _ref_params(arch):
    p = RefModel(ref_config(arch)).init(jax.random.PRNGKey(0))
    return p, params_from_jax(jax.tree.map(np.asarray, p))


def _cf(cfg, cf):
    if cf is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rs = np.random.RandomState(27)
    inp = {"granite_tokens": rs.randint(0, 512, (4, 16)),
           "zamba2_tokens": rs.randint(0, 512, (4, 16)),
           "qwen2_vl_tokens": rs.randint(0, 512, (4, 24)),
           "llama_tokens": rs.randint(0, 512, (4, 16))}
    qcfg = get_config(QWEN)
    inp["qwen2_vl_patches"] = (0.5 * rs.randn(4, 9, qcfg.d_model)).astype(
        np.float32)
    lcfg = get_config(LLAMA)
    inp["moe_x"] = rs.randn(4, 8, lcfg.d_model).astype(np.float32)
    for k in ("granite_tokens", "zamba2_tokens", "qwen2_vl_tokens",
              "llama_tokens"):
        assert inp[k].max() < min(get_config(a).vocab_size
                                  for a in (GRANITE, ZAMBA, QWEN, LLAMA))
    tmp = str(tmp_path_factory.mktemp("multidevice"))
    np.savez(os.path.join(tmp, "inp.npz"), **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF),
         os.path.join(tmp, "inp.npz"), os.path.join(tmp, "ref.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    # the port's jobs, on the reference's weights
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    params = {a: _ref_params(a) for a in (GRANITE, ZAMBA, QWEN, LLAMA)}
    lp = params[LLAMA][1]
    moe = tree_map(lambda a: a[0], lp["blocks"][0]["b"]["moe"])
    moe_q = params_from_jax(jax.tree.map(np.asarray, ref_ffn.
                            quantize_expert_weights(jax.tree.map(
                                lambda a: a[0],
                                params[LLAMA][0]["blocks"][0]["b"]["moe"]))))
    x = t["moe_x"].bfloat16()
    staged = dict(kind="staged", mesh=dict(pod=2, data=2), stages=STAGES,
                  save_logits=True, forward=True, device="cpu")
    jobs = [
        dict(staged, name="granite", cfg=get_config(GRANITE),
             params=params[GRANITE][1], batch={"tokens": t["granite_tokens"]},
             runs=[False, True], count=True),
        dict(staged, name="zamba2", cfg=get_config(ZAMBA),
             params=params[ZAMBA][1], batch={"tokens": t["zamba2_tokens"]},
             runs=[False]),
        dict(staged, name="qwen2_vl", cfg=qcfg, params=params[QWEN][1],
             batch={"tokens": t["qwen2_vl_tokens"],
                    "patch_embeds": t["qwen2_vl_patches"]}, runs=[False]),
        # the port's own seeded init: a stage's part against the full tree
        dict(kind="staged", name="seeded", mesh=dict(pod=2, data=2),
             device="cpu",
             stages=STAGES, cfg=get_config(GRANITE), seed=5,
             batch={"tokens": t["granite_tokens"]}, runs=[False],
             count=True),
        dict(kind="staged", name="seeded_full", mesh=dict(pod=2, data=2),
             device="cpu",
             stages=STAGES, cfg=get_config(GRANITE),
             params=Model(get_config(GRANITE), device="cpu").init(5),
             batch={"tokens": t["granite_tokens"]}, runs=[False]),
        dict(kind="forward", name="forward", mesh=dict(data=2, model=2),
             device="cpu",
             cfg=_cf(lcfg, 8.0), params=lp, single=True,
             batch={"tokens": t["llama_tokens"]}),
        dict(kind="moe", name="moe_seeded", mesh=dict(data=2, model=2),
             device="cpu",
             cfg=lcfg, x=x, seed=9, w8a8=True),
        dict(kind="moe", name="moe_seeded_full", mesh=dict(data=2, model=2),
             device="cpu",
             cfg=lcfg, x=x, params=ffn.init_moe_layer(lcfg, 9, "cpu",
                                                      w8a8=True)),
    ]
    for w8 in ("bf16", "w8a8"):
        for cf_key, cf in CFS.items():
            jobs.append(dict(kind="moe", name=f"moe_{w8}_{cf_key}",
                             mesh=dict(data=2, model=2), device="cpu",
                             cfg=_cf(lcfg, cf),
                             x=x, params=moe_q if w8 == "w8a8" else moe,
                             count=True))
    torch.save(jobs, os.path.join(tmp, "jobs.pt"))
    ties = _router_ties(params[LLAMA], inp["llama_tokens"])
    port = subprocess.run(
        [sys.executable, "-c",
         "import sys; from repro_torch.launch.mesh import run_world; "
         "run_world(4, 'repro_torch.launch.collab:run_jobs', "
         "sys.argv[1], sys.argv[2])",
         os.path.join(tmp, "jobs.pt"), tmp],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    out, err = ref.communicate(timeout=300)
    assert port.returncode == 0, port.stdout + port.stderr
    assert ref.returncode == 0 and "REF_OK" in out, out + err
    got = {}
    for job in jobs:
        got[job["name"]] = [torch.load(os.path.join(
            tmp, f"{job['name']}.{r}.pt"), weights_only=False)
            for r in range(4)]
    return dict(np.load(os.path.join(tmp, "ref.npz"))), got, inp, params, \
        {"moe": moe, "moe_q": moe_q, "x": x, "ties": ties}


def _router_ties(params, tokens):
    """Token rows whose expert the two packages' one-device forwards
    (llama4-smoke at capacity factor 8.0) choose apart; each must be a
    tie of the reference's router probabilities, as in
    tests/test_torch_llama4.py.  Such a row takes another expert, so its
    logits are left out of the forward's comparison."""
    cfg = _cf(get_config(LLAMA), 8.0)
    rcfg = _cf(ref_config(LLAMA), 8.0)
    ref_routes, port_routes = [], []
    ref_route, port_route = ref_ffn._route, ffn._route

    def rec_ref(x2d, w, k):
        out = ref_route(x2d, w, k)
        ref_routes.append((np.asarray(out[1]), np.asarray(out[2])))
        return out

    def rec_port(x2d, w, k):
        out = port_route(x2d, w, k)
        port_routes.append(out[1].numpy())
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_ffn, "_route", rec_ref)
        mp.setattr(ffn, "_route", rec_port)
        RefModel(rcfg).forward(params[0], {"tokens": jnp.asarray(tokens)})
        Model(cfg, device="cpu").forward(
            params[1], {"tokens": torch.from_numpy(tokens)})
    assert len(ref_routes) == len(port_routes) == 1   # one MoE layer
    (ri, rp), ti = ref_routes[0], port_routes[0]
    rows = np.nonzero((ri != ti).any(1))[0]
    for row in rows:
        gap = np.abs(rp[row][ri[row]] - rp[row][ti[row]]).max()
        assert gap < ROUTE_TIE, (row, ri[row], ti[row], rp[row])
    # what the flips move the expert-parallel aux by: on the (data 2)
    # shard holding the row, each flipped assignment moves f_e by
    # 1 / (t_local * k) from the reference's expert to the port's, and
    # aux = E * sum_e f_e * P_e is then averaged over the 2 shards
    t_local = tokens.size // 2
    k = ri.shape[1]
    shift = 0.0
    for row in rows:
        p_mean = rp[row // t_local * t_local:][:t_local].mean(0)
        for j in np.nonzero(ri[row] != ti[row])[0]:
            shift += (cfg.moe.num_experts / (t_local * k)
                      * (p_mean[ti[row, j]] - p_mean[ri[row, j]]) / 2)
    return sorted(int(r) for r in rows), float(shift)


def _same_on_every_rank(outs, key):
    for o in outs[1:]:
        assert torch.equal(o[key], outs[0][key]), (key, o["rank"])


def _staged_logits(outs, run_i=0):
    for o in outs[1:]:
        assert o["runs"][run_i]["digest"] == outs[0]["runs"][run_i]["digest"]
    return outs[0]["runs"][run_i]["logits"]


def test_staged_ranks_hold_their_stage(run):
    _, got, _, _, _ = run
    for o in got["granite"]:
        assert o["blocks"] == [o["coords"]["pod"]]
        assert o["runs"][0]["shape"] == (4, 16, get_config(GRANITE).vocab_size)
    # a rank's seeded part equals that part of the full init
    for a, b in zip(got["seeded"], got["seeded_full"]):
        assert a["runs"][0]["digest"] == b["runs"][0]["digest"]
        assert a["param_bytes"] == b["param_bytes"]


def test_staged_granite_raw(run):
    ref, got, _, _, _ = run
    raw = _staged_logits(got["granite"])
    assert torch.equal(raw, got["granite"][0]["forward"])     # bit for bit
    assert np.abs(raw.numpy() - ref["granite_raw"]).max() < ATOL
    for o in got["granite"]:
        h, head = o["runs"][0]["handoffs"]
        assert h["side"] == ("send" if o["coords"]["pod"] == 0 else "recv")
        assert head["side"] == "head"
        assert head["bytes"] == raw[:2].numel() * 4     # a rank's rows
        assert h["bytes"] == 2 * 16 * get_config(GRANITE).d_model * 2


def test_staged_granite_compressed(run):
    ref, got, _, _, _ = run
    raw = _staged_logits(got["granite"], 0)
    comp = _staged_logits(got["granite"], 1)
    err = np.abs(comp.numpy() - ref["granite_compressed"]).max()
    assert err < ATOL, err
    # the reference's own bounds (tests/test_multidevice.py)
    d = float((comp - raw).abs().max())
    assert 0.0 < d < 1.0, d
    assert got["granite"][0]["compressed_vs_raw"] == d
    d_model = get_config(GRANITE).d_model
    for o in got["granite"]:
        h, _ = o["runs"][1]["handoffs"]
        assert h["bytes"] == 2 * 16 * (d_model + 4)     # int8 rows + scales
        if h["side"] == "send":     # the kernels' plain versions, bitwise
            assert h["q_equal"] and h["scale_equal"]
        else:
            assert h["x_equal"]
        assert h["q"].dtype == torch.int8
    send, recv = (o["runs"][1]["handoffs"][0] for o in got["granite"][::2])
    assert torch.equal(send["q"], recv["q"])          # the handoff is a copy
    assert torch.equal(send["scale"], recv["scale"])


def test_staged_zamba2_shared_attn_owner_rule(run):
    """zamba2-smoke's plan: mamba, shared attention, exit, mamba, shared
    attention.  Under the reference's owner rule both sites fall to pod 0
    (stages[min(bi, len - 1) - 1]), the first just after pod 0 has handed
    its activation over, the second after pod 1's block: the live path
    runs neither, so staged logits differ from the forward's."""
    ref, got, _, _, _ = run
    raw = _staged_logits(got["zamba2"])
    assert np.abs(raw.numpy() - ref["zamba2_raw"]).max() < ATOL
    fwd = got["zamba2"][0]["forward"]
    assert float((raw - fwd).abs().max()) > 10 * ATOL


def test_staged_qwen2_vl_mrope(run):
    ref, got, _, _, _ = run
    raw = _staged_logits(got["qwen2_vl"])
    assert np.abs(raw.numpy() - ref["qwen2_vl_raw"]).max() < ATOL
    assert torch.equal(raw, got["qwen2_vl"][0]["forward"])


def _moe_close(y, want):
    y = np.asarray(y, np.float32)
    assert np.all(np.abs(y - want) <= MOE_TOL * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("w8", ["bf16", "w8a8"])
@pytest.mark.parametrize("cf_key", sorted(CFS))
def test_moe_expert_parallel_matches_reference(run, w8, cf_key):
    ref, got, _, _, _ = run
    name = f"moe_{w8}_{cf_key}"
    outs = got[name]
    _same_on_every_rank(outs, "y")
    _same_on_every_rank(outs, "aux")
    assert all(o["local_experts"] == 2 for o in outs)
    _moe_close(outs[0]["y"].float().numpy(), ref[name + "_y"])
    assert abs(float(outs[0]["aux"]) - float(ref[name + "_aux"])) < AUX_TOL
    for o in outs:          # CPU calls of the kernel wrappers never count
        assert not any(o["launches"].values())


@pytest.mark.parametrize("w8", ["bf16", "w8a8"])
def test_moe_dropless_matches_single_device(run, w8):
    _, got, inp, _, t = run
    cfg = _cf(get_config(LLAMA), 8.0)
    p = t["moe_q"] if w8 == "w8a8" else t["moe"]
    x = t["x"]
    y1, _ = ffn.moe_ffn_reference(p, x, cfg, tokens_for_capacity=2 * 8)
    _moe_close(got[f"moe_{w8}_cf8"][0]["y"].float().numpy(),
               y1.float().numpy())
    auxs = [float(ffn.moe_ffn_reference(p, x[i:i + 2], cfg)[1])
            for i in (0, 2)]
    assert abs(float(got[f"moe_{w8}_cf8"][0]["aux"])
               - sum(auxs) / 2) < AUX_TOL
    # and the reference's own single-device layer on the same inputs
    rp = jax.tree.map(lambda a: a[0],
                      run[3][LLAMA][0]["blocks"][0]["b"]["moe"])
    if w8 == "w8a8":
        rp = ref_ffn.quantize_expert_weights(rp)
    ry, _ = ref_ffn.moe_ffn_reference(rp, jnp.asarray(inp["moe_x"],
                                                      jnp.bfloat16),
                                      cfg, tokens_for_capacity=2 * 8)
    _moe_close(got[f"moe_{w8}_cf8"][0]["y"].float().numpy(),
               np.asarray(ry.astype(jnp.float32)))


def test_moe_seeded_shards_equal_a_full_layer(run):
    _, got, _, _, _ = run
    for a, b in zip(got["moe_seeded"], got["moe_seeded_full"]):
        assert torch.equal(a["y"], b["y"]) and torch.equal(a["aux"], b["aux"])


def test_model_forward_expert_parallel(run):
    """``Model(cfg, ctx=ShardCtx(mesh)).forward`` on llama4-smoke (capacity
    factor 8.0, so no drop order moves a row): every rank's logits equal,
    equal to the port's one-device forward bit for bit, and within 2e-2
    of the reference's expert-parallel forward on every row but the router
    ties of the two packages (asserted ties, at most one row here); aux
    within 1e-3 once the tie's own move of the load-balance loss is
    counted."""
    ref, got, _, _, t = run
    outs = got["forward"]
    _same_on_every_rank(outs, "logits")
    logits = outs[0]["logits"]
    assert torch.equal(logits, outs[0]["single_logits"])
    err = np.abs(logits.numpy() - ref["forward_logits"]).max(-1).reshape(-1)
    rows, shift = t["ties"]
    assert len(rows) <= 1
    keep = np.setdiff1d(np.arange(err.size), rows)
    assert err[keep].max() < ATOL, err
    assert abs(float(outs[0]["aux"]) - float(ref["forward_aux"])
               - shift) < AUX_TOL


# ---------------------------------------------------------------------------
# the collective counter (sharding.comm.count_collectives)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("w8", ["bf16", "w8a8"])
@pytest.mark.parametrize("cf_key", sorted(CFS))
def test_moe_all_reduce_bytes_equal_the_references_hlo(run, w8, cf_key):
    """Each rank records two all-reduces: the combine of the shards'
    partial y over "model" in bf16 [B*S / data, D] and the aux loss over
    "data" (fp32, 4 bytes); together what ``collective_bytes_from_hlo``
    reads off the reference's lowered shard_map program.  XLA's CPU
    compiler then promotes the bf16 all-reduce to fp32, so the compiled
    module's all-reduce bytes are twice the combine's plus the aux's."""
    ref, got, _, _, _ = run
    name = f"moe_{w8}_{cf_key}"
    d = get_config(LLAMA).d_model
    y_bytes = 4 * 8 // 2 * d * 2            # [B*S / data, D] bf16
    for o in got[name]:
        recs = o["collectives"]
        reduces = [r for r in recs if r["kind"] == "all-reduce"]
        assert [r["bytes"] for r in reduces] == [y_bytes, 4], recs
        assert all("models/ffn.py" in r["site"] and "moe_ffn" in r["site"]
                   for r in recs), recs
        assert sum(r["bytes"] for r in reduces) \
            == ref[name + "_all_reduce_lowered"]
        assert ref[name + "_all_reduce_compiled"] == 2 * y_bytes + 4
        gathers = [r for r in recs if r["kind"] == "all-gather"]
        assert [r["bytes"] for r in gathers] == [4 * 8 * d * 2]


def test_counting_changes_no_bit(run):
    """A run under the counter gives the same bits as one without it: the
    MoE layer run twice in one job, and a staged run with a counter
    against the same seeded run without one (``seeded_full``)."""
    _, got, _, _, _ = run
    for w8 in ("bf16", "w8a8"):
        for cf_key in CFS:
            for o in got[f"moe_{w8}_{cf_key}"]:
                assert torch.equal(o["y"], o["y_uncounted"])
    for a, b in zip(got["seeded"], got["seeded_full"]):
        assert "collectives" in a["runs"][0]
        assert "collectives" not in b["runs"][0]
        assert a["runs"][0]["digest"] == b["runs"][0]["digest"]


def test_staged_boundary_bytes_are_the_shape_count(run):
    """The counter's records of a staged granite run on (pod 2, data 2):
    the boundary is one collective-permute on each side (raw: 2 rows x 16
    tokens x D bf16; int8: the rows and their fp32 scales, two records),
    the head's logits one broadcast of this rank's rows, then one
    all-gather of every row over "data"."""
    _, got, _, _, _ = run
    cfg = get_config(GRANITE)
    d, v = cfg.d_model, cfg.vocab_size
    for o in got["granite"]:
        raw, comp = (r["collectives"] for r in o["runs"])
        perm = [r["bytes"] for r in raw if r["kind"] == "collective-permute"]
        assert perm == [2 * 16 * d * 2]
        perm = [r["bytes"] for r in comp if r["kind"] == "collective-permute"]
        assert perm == [2 * 16 * d, 2 * 16 * 4]
        for recs in (raw, comp):
            assert [r["bytes"] for r in recs if r["kind"] == "broadcast"] \
                == [2 * 16 * v * 4]
            assert [r["bytes"] for r in recs if r["kind"] == "all-gather"] \
                == [4 * 16 * v * 4]
            assert all("core/hierarchy.py" in r["site"] for r in recs), recs
