"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run through the harness on the CPU (the
look for a card is ``run.py``'s alone) with one fault planted in the
program: a decode step that leaves the cache unchanged, half of the batch
left out, a token or an answer altered where it is produced, an exit
head's entropy altered, and exit heads that always fire.  The exchange between chips has no fault to
plant: every cell runs on one card."""
import pytest
import torch

from bench.conftest import run_small


def test_sound_runs_are_correct(small_root):
    for name in ("small.decode", "small.score"):
        out = run_small(small_root, name, trace=True)
        assert out["correct"], (name, out["checks"])
        assert out["failed"] == 0


def test_decode_state_left_unchanged(small_root, monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "paged_write",
                        lambda pool, paged, pos, val: pool)
    out = run_small(small_root, "small.decode")
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > \
        out["checks"]["token_gap"]["limit"]


def _half_batch(fn, *outputs):
    """``fn`` run on the first half of the rows, its results copied into
    the second half."""
    def broken(self, params, cache, tokens, *a, **kw):
        h = tokens.shape[0] // 2
        mixed = torch.cat([tokens[:h], tokens[:tokens.shape[0] - h]])
        return fn(self, params, cache, mixed, *a, **kw)
    return broken


def test_decode_half_batch_left_out(small_root, monkeypatch):
    from repro_torch.models.model import Model
    monkeypatch.setattr(Model, "decode_step",
                        _half_batch(Model.decode_step))
    out = run_small(small_root, "small.decode")
    assert not out["correct"]


def test_decode_token_altered(small_root, monkeypatch):
    from repro_torch.serving.scheduler import ContinuousBatchScheduler
    commit = ContinuousBatchScheduler._commit_window

    def altered(self, ring, part, rep):
        ring = ring.copy()
        ring[0, -1] = (ring[0, -1] + 1) % self._vocab
        return commit(self, ring, part, rep)
    monkeypatch.setattr(ContinuousBatchScheduler, "_commit_window", altered)
    out = run_small(small_root, "small.decode")
    assert not out["correct"]


def test_decode_exits_always_fire(small_root, monkeypatch):
    from repro_torch.serving import window
    monkeypatch.setattr(window, "first_exit_index",
                        lambda ee, thr, vocab: torch.zeros(
                            ee.shape[1], dtype=torch.int64))
    out = run_small(small_root, "small.decode")
    assert not out["correct"]
    assert out["checks"]["exit_share_gap"]["value"] == pytest.approx(1.0)


def test_decode_exit_entropy_altered(small_root, monkeypatch):
    from repro_torch.models import model as model_mod
    entropy = model_mod._entropy
    monkeypatch.setattr(model_mod, "_entropy",
                        lambda logits: entropy(logits * 1.05))
    out = run_small(small_root, "small.decode")
    assert not out["correct"]
    assert out["checks"]["exit_entropy_gap"]["value"] > \
        out["checks"]["exit_entropy_gap"]["limit"]


def test_score_half_batch_left_out(small_root, monkeypatch):
    from repro_torch.models.model import Model
    forward = Model.forward

    def broken(self, params, batch, **kw):
        t = batch["tokens"]
        h = t.shape[0] // 2
        return forward(self, params, {"tokens": torch.cat(
            [t[:h], t[:t.shape[0] - h]])}, **kw)
    monkeypatch.setattr(Model, "forward", broken)
    out = run_small(small_root, "small.score")
    assert not out["correct"]


def test_score_answer_altered(small_root, monkeypatch):
    from repro_torch.models.model import Model
    forward = Model.forward

    def altered(self, params, batch, **kw):
        out = forward(self, params, batch, **kw)
        out.logits[0, -1, 0] += 1.0
        return out
    monkeypatch.setattr(Model, "forward", altered)
    out = run_small(small_root, "small.score")
    assert not out["correct"]
