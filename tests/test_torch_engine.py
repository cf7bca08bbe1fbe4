"""The port's serving front half on the CPU against the reference:
``AdaptiveExitController`` and the scheduler's control loop, and
``ServingEngine`` (``generate``, the tiered path, ``generate_multi``,
``exit_stats``) on granite-3-2b-smoke with deepseek-v3-671b-smoke as a
second pool entry, the same weights through the bridge.

* The controller's arithmetic equals the reference's, case by case.
* Driven by the scheduler, the port's threshold sequence equals the
  reference's on the same weights and prompts.
* ``generate`` gives the reference engine's greedy tokens (a top-2 tie
  under 1e-2 excused only as a tie) and the port's own scheduler's bit
  for bit; the exit statistics and measured depth equal the reference's.
* The tiered engine routes as the reference's does and returns the
  single-pool engine's tokens; ``generate_multi`` equals dedicated
  engines bit for bit.
* An async engine whose threshold moves keeps one window build.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import Scenario as RefScenario
from repro.models import Model as RefModel
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import ModelGroup as RefGroup
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro.serving import ServeConfig as RefServeConfig
from repro.serving import ServingEngine as RefEngine
from repro.serving.adaptive import AdaptiveExitController as RefController
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core import Scenario
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve
from repro_torch.models import Model
from repro_torch.serving import (AdaptiveExitController,
                                 ContinuousBatchScheduler, ModelGroup,
                                 Request, SchedulerConfig, ServeConfig,
                                 ServingEngine, make_serve_step)

ARCH = "granite-3-2b-smoke"
POOL = ("granite-3-2b-smoke", "deepseek-v3-671b-smoke")
TIE = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(name, ref model, ref params, port model, port params) each."""
    out = []
    for i, arch in enumerate(POOL):
        rm = RefModel(ref_config(arch))
        rp = rm.init(jax.random.PRNGKey(i))
        tm = Model(get_config(arch), device="cpu")
        out.append((arch, rm, rp, tm,
                    params_from_jax(jax.tree.map(np.asarray, rp))))
    return out


def _prompts(seed, b, s, vocab=1000):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _tie_or_equal(rm, rp, prompt, got, want):
    """Equal streams, or a first difference at a top-2 tie (within 1e-2)
    of the reference's logits."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    if got == want:
        return
    seq = np.concatenate([prompt, np.asarray(want[:-1], np.int32)])
    logits, _ = rm.prefill(rp, {"tokens": jnp.asarray(seq)[None]})
    logs = np.asarray(logits[0, prompt.size - 1:])
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    gap = float(logs[k][want[k]] - logs[k][got[k]])
    assert 0.0 <= gap < TIE, f"token {k}: ref logit gap {gap:.3e}"


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

CONTROL_CASES = {
    # the reference's test_adaptive.py cases, as update sequences
    "converges": (0.7, 0.1, [("plant", 1.0)] * 60),
    "loosens": (0.5, 0.1, [("update", [0.0], [0.4])]),
    "tightens": (0.9, 0.9, [("update", [1.0], [0.4])]),
    "bounded_hi": (0.01, 0.5, [("update", [0.0], [0.4])] * 100),
    "bounded_lo": (1.0, 0.5, [("update", [1.0], [0.4])] * 100),
    "single_path": (0.5, 0.5, [("update", [0.5], [0.4]),
                               ("measured", 0.2), ("measured", 0.7)]),
    "two_heads": (0.5, 0.5, [("update", [0.3, 0.3], [0.25, 0.5])] * 5),
}


def _drive(ctrl, steps):
    """Apply an update sequence; returns the thresholds and the expected
    depths it saw.  ``plant`` is the reference's toy plant (the exit
    fraction at one head at 0.4 depth grows with the threshold)."""
    seen = []
    for st in steps:
        if st[0] == "plant":
            frac = min(0.95, st[1] * ctrl.threshold)
            seen.append(ctrl.expected_depth_fraction([frac], [0.4]))
            ctrl.update([frac], [0.4])
        elif st[0] == "update":
            seen.append(ctrl.expected_depth_fraction(st[1], st[2]))
            ctrl.update(st[1], st[2])
        else:
            ctrl.update_measured(st[1])
        seen.append(ctrl.threshold)
    return seen


@pytest.mark.parametrize("case", sorted(CONTROL_CASES))
def test_controller_matches_reference(case):
    target, thr, steps = CONTROL_CASES[case]
    port = AdaptiveExitController(target_depth_fraction=target, threshold=thr)
    ref = RefController(target_depth_fraction=target, threshold=thr)
    got, want = _drive(port, steps), _drive(ref, steps)
    assert got == want
    assert port.lo <= port.threshold <= port.hi
    if case == "converges":
        depths = got[-20::2]
        assert abs(np.mean(depths) - 0.7) < 0.1
    if case in ("loosens", "bounded_hi"):
        assert port.threshold > thr
    if case in ("tightens", "bounded_lo"):
        assert port.threshold < thr


@pytest.mark.parametrize("target", [0.01, 1.0], ids=["loosen", "tighten"])
def test_scheduler_drives_controller_like_reference(models, target):
    """Every ``adaptive_every`` = 4 served tokens the scheduler feeds the
    measured depth to the controller; the port's threshold sequence equals
    the reference's, and so do the served tokens and exit counts."""
    _, rm, rp, tm, tp = models[0]
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 1000, n).astype(np.int32) for n in (4, 6, 5, 3)]
    runs = []
    for sched_cls, req_cls, ctrl_cls, cfg_cls, m, p, kw in (
            (ContinuousBatchScheduler, Request, AdaptiveExitController,
             SchedulerConfig, tm, tp, {"device": "cpu"}),
            (RefScheduler, RefRequest, RefController, RefConfig, rm, rp, {})):
        ctrl = ctrl_cls(target_depth_fraction=target, threshold=0.5)
        seq = []
        update = ctrl.update_measured

        def record(depth, update=update, seq=seq):
            seq.append((depth, update(depth)))
        ctrl.update_measured = record
        sched = sched_cls(m, p, cfg_cls(n_slots=2, max_len=32),
                          controller=ctrl, **kw)
        sched.adaptive_every = 4
        reqs = [req_cls(tokens=t, max_new=8) for t in prompts]
        for r in reqs:
            sched.submit(r)
        sched.run()
        runs.append((seq, sched.tokens_served,
                     sched.flush_counters().tolist(),
                     [list(r.out_tokens) for r in reqs]))
    (got, n, counts, toks), (want, n_ref, counts_ref, toks_ref) = runs
    assert len(got) >= 7 and got == want
    assert n == n_ref == 32 and counts == counts_ref
    for prompt, g, w in zip(prompts, toks, toks_ref):
        _tie_or_equal(rm, rp, prompt, g, w)
    moved = got[-1][1]
    assert (moved > 0.5) if target < 0.5 else (moved < 0.5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_generate_matches_reference_and_scheduler(models):
    """``generate`` on 3 x 7 prompts, twice (the second call reuses the
    cached scheduler): the reference engine's tokens under the tie rule,
    the port scheduler's bit for bit; exit statistics and measured depth
    equal the reference engine's."""
    _, rm, rp, tm, tp = models[0]
    eng = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.9))
    ref = RefEngine(rm, rp, RefServeConfig(exit_threshold=0.9))
    for seed in (1, 2):
        prompts = _prompts(seed, 3, 7)
        got = eng.generate(torch.from_numpy(prompts), max_new=6)
        want = np.asarray(ref.generate(jnp.asarray(prompts), max_new=6))
        assert got.dtype == torch.int32 and tuple(got.shape) == (3, 6)
        for p, g, w in zip(prompts, got.numpy(), want):
            _tie_or_equal(rm, rp, p, g, w)
        sched = ContinuousBatchScheduler(
            tm, tp, SchedulerConfig(n_slots=3, max_len=13,
                                    exit_threshold=0.9), device="cpu")
        reqs = [Request(tokens=p, max_new=6) for p in prompts]
        for r in reqs:
            sched.submit(r)
        sched.run()
        assert got.tolist() == [r.out_tokens for r in reqs]
    assert len(eng._scheds) == 1
    st, st_ref = eng.exit_stats(), ref.exit_stats()
    assert st == pytest.approx(st_ref, abs=0, rel=1e-12)
    assert st["tokens"] == 36.0
    assert eng.measured_depth_fraction() == ref.measured_depth_fraction()
    step = make_serve_step(tm)
    cache = tm.init_decode_cache(2, 8)
    logits, ee, _ = step(tp, cache, torch.zeros((2, 1), dtype=torch.long), 0)
    assert tuple(logits.shape) == (2, tm.cfg.vocab_size)
    assert tuple(ee.shape) == (tm.n_exits, 2)


def test_tiered_engine_routes_like_reference(models):
    """With a scenario every row routes through the tiered cluster (raw
    handoff): the per-tier route counts equal the reference engine's and
    the tokens equal the single-pool engine's bit for bit.  A sampled
    engine routes too, its tier pools sampling at its temperature (as the
    reference's cluster does): one generator seed, the same tokens."""
    _, rm, rp, tm, tp = models[0]
    prompts = _prompts(3, 4, 9)
    plan = get_config("granite-3-2b")
    eng = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5),
                        scenario=Scenario.default(), plan_cfg=plan)
    ref = RefEngine(rm, rp, RefServeConfig(exit_threshold=0.5),
                    scenario=RefScenario.default(),
                    plan_cfg=ref_config("granite-3-2b"))
    got = eng.generate(prompts, max_new=5)
    ref.generate(jnp.asarray(prompts), max_new=5)
    assert eng.route_counts == ref.route_counts
    assert sum(eng.route_counts.values()) == 4
    assert eng._cluster.cfg.kv_handoff == "raw"
    single = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5))
    assert got.tolist() == single.generate(prompts, max_new=5).tolist()
    assert eng.exit_stats()["tokens"] == 20.0
    assert eng.exit_stats() == single.exit_stats()
    sampled = [ServingEngine(tm, tp, ServeConfig(temperature=0.7),
                             scenario=Scenario.default(), plan_cfg=plan)
               .generate(prompts, max_new=5,
                         rng=torch.Generator().manual_seed(1)).tolist()
               for _ in range(2)]
    assert sampled[0] == sampled[1] != got.tolist()


def test_generate_multi_matches_dedicated_engines(models):
    """granite and deepseek-v3 smoke batches through one ``ModelGroup``
    engine equal two dedicated engines bit for bit, with per-model exit
    counters; the tiered group engine routes as the reference's does."""
    group = ModelGroup([(n, tm, tp) for n, _, _, tm, tp in models])
    eng = ServingEngine(group, scfg=ServeConfig(exit_threshold=0.5))
    batches = {POOL[0]: _prompts(4, 2, 6), POOL[1]: _prompts(5, 3, 8)}
    got = eng.generate_multi(batches, max_new=5)
    for (name, _, _, tm, tp) in models:
        solo = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.5))
        assert got[name].tolist() == solo.generate(batches[name],
                                                   max_new=5).tolist()
        assert eng.exit_counts_by_model[name].tolist() \
            == solo.exit_counts.tolist()
        assert eng.tokens_served_by_model[name] == solo.tokens_served
    st = eng.exit_stats()
    assert st[POOL[0]]["tokens"] == 10.0 and st[POOL[1]]["tokens"] == 15.0
    with pytest.raises(ValueError):
        eng.generate(batches[POOL[0]])

    plans = {POOL[0]: get_config("granite-3-2b"),
             POOL[1]: get_config("deepseek-v3-671b")}
    ref_plans = {POOL[0]: ref_config("granite-3-2b"),
                 POOL[1]: ref_config("deepseek-v3-671b")}
    tiered = ServingEngine(group, scfg=ServeConfig(exit_threshold=0.5),
                           scenario=Scenario.default(), plan_cfg=plans)
    ref = RefEngine(RefGroup([(n, rm, rp) for n, rm, rp, _, _ in models]),
                    scfg=RefServeConfig(exit_threshold=0.5),
                    scenario=RefScenario.default(), plan_cfg=ref_plans)
    out = tiered.generate_multi(batches, max_new=5)
    ref.generate_multi({m: jnp.asarray(p) for m, p in batches.items()},
                       max_new=5)
    assert tiered.route_counts == ref.route_counts
    for name in POOL:
        assert out[name].tolist() == got[name].tolist()
    assert tiered.exit_stats()[POOL[1]]["tokens"] == 15.0


def test_async_engine_moving_threshold_keeps_one_build(models):
    """``enable_adaptive`` on an async engine: the controller moves the
    threshold every 4 tokens, the window's threshold scalar follows, and
    the window is built once; tokens equal the sync engine's."""
    _, _, _, tm, tp = models[0]
    prompts = _prompts(6, 3, 5)
    eng = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.3,
                                            async_decode=True,
                                            readback_interval=3))
    eng.enable_adaptive(0.01, update_every=4)
    got = eng.generate(prompts, max_new=12)
    sched = next(iter(eng._scheds.values()))
    assert eng.controller.threshold > 0.3
    # the window read the threshold of its last dispatch, before the
    # closing commits moved the controller on
    assert 0.3 < sched._window.threshold <= eng.controller.threshold
    assert float(sched._window.thr) == np.float32(sched._window.threshold)
    assert sched.jit_cache_sizes() == {"decode_window": 1}
    sync = ServingEngine(tm, tp, ServeConfig(exit_threshold=0.3))
    assert got.tolist() == sync.generate(prompts, max_new=12).tolist()
    assert eng.measured_depth_fraction() == 1.0


def test_batch_mode_entry_point(models, capsys):
    """``serve`` and ``--mode batch``: seeded numpy prompts through the
    engine on the CPU, equal to the engine on the same prompts."""
    _, _, _, tm, tp = models[0]
    out, stats = serve(ARCH, 2, 6, 4, params=tp, device="cpu", quiet=True)
    prompts = np.random.RandomState(0).randint(
        0, tm.cfg.vocab_size, (2, 6)).astype(np.int32)
    eng = ServingEngine(tm, tp, ServeConfig())
    assert out.tolist() == eng.generate(prompts, max_new=4).tolist()
    assert stats["tokens"] == 8.0
    serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "5", "--max-new", "3"])
    assert "generated (2, 3)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve_main(["--arch", ARCH, "--device", "cpu", "--tiered"])
