"""Slot migration in the port's scheduler (``export_slot`` /
``import_slot``) on the CPU, against unmigrated runs and against the
reference scheduler's snapshots (granite-3-2b-smoke, the same weights
through the bridge).

* A raw export imported into an arena with another slot count continues
  with the greedy tokens of an unmigrated run (contiguous and paged).
* ``payload_bytes`` equals the layout-derived ``slot_payload_bytes``.
* Given the same cache rows (the reference's raw snapshot imported into
  the port), the port's compressed snapshot equals the reference
  scheduler's ``export_slot(compress=True)`` bit for bit and ships under
  0.7x the raw bytes.  The rows themselves come from two frameworks'
  bf16 matmuls, which need not agree to the last bit.
* A paged import writes the shipped pages only: borrowed prefix pages and
  every other page of the pool keep their bytes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import Model as RefModel
from repro.serving import ContinuousBatchScheduler as RefScheduler
from repro.serving import Request as RefRequest
from repro.serving import SchedulerConfig as RefConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving.scheduler import (ContinuousBatchScheduler, Request,
                                           SchedulerConfig, SlotSnapshot)

ARCH = "granite-3-2b-smoke"
MAX_NEW = 10


@pytest.fixture(scope="module")
def models():
    rm = RefModel(ref_config(ARCH))
    rp = rm.init(jax.random.PRNGKey(0))
    tm = Model(get_config(ARCH), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, rp))
    return rm, rp, tm, tp


def _cfg(cls, n_slots, paged):
    return cls(n_slots=n_slots, max_len=32, prefill_chunk=4,
               exit_threshold=0.6, paged=paged, page_size=16)


def _prompt(seed, n=9):
    return np.random.RandomState(seed).randint(0, 1000, n).astype(np.int32)


def _mid_flight(sched_cls, req_cls, model, params, prompt, paged, polls=5,
                **kw):
    sched = sched_cls(model, params, _cfg(
        SchedulerConfig if sched_cls is ContinuousBatchScheduler
        else RefConfig, 2, paged), **kw)
    req = req_cls(tokens=prompt.copy(), max_new=MAX_NEW)
    sched.submit(req)
    for _ in range(polls):
        sched.poll()
    assert not req.done and sched.active[req.slot]
    return sched, req


def _unmigrated(tm, tp, prompt, paged):
    s = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, 2, paged),
                                 device="cpu")
    r = Request(tokens=prompt.copy(), max_new=MAX_NEW)
    s.submit(r)
    s.run()
    return r.out_tokens


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return (t.view(view[t.dtype]) if t.dtype in view else t).numpy()


def _port_snapshot(js):
    """The reference's raw snapshot as a port snapshot (host tensors, a
    port ``Request`` with the same tokens and progress)."""
    r = js.req
    req = Request(tokens=np.asarray(r.tokens, np.int32), max_new=r.max_new,
                  req_id=r.req_id, out_tokens=list(r.out_tokens))
    return SlotSnapshot(
        req=req, position=js.position, current_tok=js.current_tok, steps_taken=js.steps_taken,
        compressed=False, payload=[_to_torch(a) for a in js.payload],
        scales=[None] * len(js.payload), payload_bytes=js.payload_bytes,
        paged=js.paged, page_skip=js.page_skip, page_used=js.page_used,
        page_digests=list(js.page_digests))


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_raw_migration_continues_greedy_tokens(models, paged):
    _, _, tm, tp = models
    prompt = _prompt(0)
    want = _unmigrated(tm, tp, prompt, paged)
    src, req = _mid_flight(ContinuousBatchScheduler, Request, tm, tp, prompt,
                           paged, device="cpu")
    snap = src.export_slot(req.slot)
    assert snap.position > prompt.size and snap.payload_bytes > 0
    src.release_slot(req.slot)
    assert not src.has_work
    dst = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, 3, paged),
                                   device="cpu")
    dst.submit(Request(tokens=_prompt(1, 5), max_new=4))   # a neighbour
    dst.poll()
    slot = dst.import_slot(snap)
    assert dst.active[slot] and dst.slot_req[slot] is req
    dst.run()
    assert req.done and req.out_tokens == want
    assert dst.n_imported == 1 and src.n_exported == 1


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_payload_bytes_match_layout_and_truncate(models, paged):
    _, _, tm, tp = models
    src, req = _mid_flight(ContinuousBatchScheduler, Request, tm, tp,
                           _prompt(6), paged, polls=3, device="cpu")
    early = src.export_slot(req.slot)
    assert src.slot_payload_bytes(req.slot) == early.payload_bytes
    full = sum(int(np.prod(shape)) * dt.itemsize
               for shape, dt in src._row_struct_flat)
    assert early.payload_bytes < full
    for _ in range(4):
        src.poll()
    late = src.export_slot(req.slot)
    assert src.slot_payload_bytes(req.slot) == late.payload_bytes
    assert late.position > early.position
    assert late.payload_bytes >= early.payload_bytes
    assert all(ax == 1 for ax in src._row_axes_flat)


@pytest.mark.parametrize("paged", [False, True], ids=["contig", "paged"])
def test_compressed_payload_matches_reference_bitwise(models, paged):
    rm, rp, tm, tp = models
    prompt = _prompt(2)
    ref_src, ref_req = _mid_flight(RefScheduler, RefRequest, rm, rp, prompt,
                                   paged)
    raw = ref_src.export_slot(ref_req.slot)
    want = ref_src.export_slot(ref_req.slot, compress=True)
    assert ref_src.slot_payload_bytes(ref_req.slot) == raw.payload_bytes

    port = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, 2, paged),
                                    device="cpu")
    slot = port.import_slot(_port_snapshot(raw))
    assert port.slot_payload_bytes(slot) == raw.payload_bytes
    same_raw = port.export_slot(slot)
    for a, b in zip(same_raw.payload, raw.payload):
        np.testing.assert_array_equal(_bits(a), _bits(_to_torch(b)))
    got = port.export_slot(slot, compress=True)
    assert got.compressed and got.payload_bytes == want.payload_bytes
    assert got.payload_bytes < 0.7 * raw.payload_bytes
    assert (got.page_skip, got.page_used) == (want.page_skip, want.page_used)
    assert got.page_digests == list(want.page_digests)
    for q, s, wq, ws in zip(got.payload, got.scales, want.payload,
                            want.scales):
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(_bits(s), _bits(_to_torch(ws)))

    # the port's int8 payload continues decoding in another arena
    port.release_slot(slot)
    dst = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, 3, paged),
                                   device="cpu")
    dst.import_slot(got)
    dst.run()
    assert got.req.done and len(got.req.out_tokens) == MAX_NEW


def test_paged_import_writes_only_shipped_pages(models):
    """The destination already holds the prompt's first page (a finished
    request with the same prefix), so the export skips it; the import
    borrows it and copies the shipped pages into fresh ones.  Every other
    page of the pool, the borrowed one included, keeps its bytes, and
    decoding continues with the unmigrated run's greedy tokens."""
    _, _, tm, tp = models
    prompt = _prompt(3, 20)                # one full 16-token page + 4
    want = _unmigrated(tm, tp, prompt, True)
    dst = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, 3, True),
                                   device="cpu")
    dst.submit(Request(tokens=np.concatenate([prompt[:16], _prompt(4, 3)]),
                       max_new=2))
    dst.run()
    assert len(dst.prefix_cache) >= 1
    src, req = _mid_flight(ContinuousBatchScheduler, Request, tm, tp, prompt,
                           True, polls=3, device="cpu")
    snap = src.export_slot(req.slot, skip_keys=dst.prefix_keys())
    assert snap.page_skip == 1 and snap.page_used == 2
    assert snap.payload[0].shape[1] == 1             # one page shipped
    # stale bytes in every page no prefix holds, so a stray write shows
    g = torch.Generator().manual_seed(0)
    cold = [p for p in range(dst.page_alloc.n_pages)
            if p not in dst.prefix_cache.pages()]
    for c in dst.cache["blocks"]:
        for a in c:
            a[:, cold] = torch.randn(a[:, cold].shape,
                                     generator=g).to(a.dtype)
    before = [a.clone() for c in dst.cache["blocks"] for a in c]
    slot = dst.import_slot(snap)
    row = dst._tbl[slot]
    shipped = int(row[1])
    assert dst.prefix_cache.pages()[int(row[0])] == snap.page_digests[0]
    after = [a for c in dst.cache["blocks"] for a in c]
    for b, a, payload in zip(before, after, snap.payload):
        others = [p for p in range(a.shape[1]) if p != shipped]
        assert torch.equal(a[:, others], b[:, others])
        assert torch.equal(a[:, shipped], payload[:, 0])
    dst.run()
    assert req.done and req.out_tokens == want


def test_import_rejects_mismatched_or_finished_snapshots(models):
    _, _, tm, tp = models
    src, req = _mid_flight(ContinuousBatchScheduler, Request, tm, tp,
                           _prompt(5), False, device="cpu")
    snap = src.export_slot(req.slot)
    paged = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, 2, True),
                                     device="cpu")
    with pytest.raises(ValueError):
        paged.import_slot(snap)
    with pytest.raises(ValueError):
        src.export_slot(1 - req.slot)              # an empty slot
    full = ContinuousBatchScheduler(tm, tp, _cfg(SchedulerConfig, 1, False),
                                    device="cpu")
    full.submit(Request(tokens=_prompt(6, 4), max_new=8))
    full.poll()
    with pytest.raises(RuntimeError):
        full.import_slot(snap)
