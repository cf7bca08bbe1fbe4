"""The port's analyzer, static layer: the SYN rules fire on seeded
violations and stay quiet on the legal readbacks, the CLI gates on new
findings only, the port's tree is clean against its committed baseline
(``analysis_baseline_torch.json``), every rule explains itself, and a
corrupt baseline gives an actionable error.  Mirrors the reference's
``tests/test_analysis.py`` and the CLI half of ``test_analysis_deep.py``
where a torch meaning exists (the TRC, IPC, PLT and JXP001-003 rules have
none and are not registered)."""
import json
import os

import pytest

from repro_torch.analysis import (RULES, Finding, lint_paths, lint_source,
                                  load_baseline, new_findings,
                                  save_baseline)
from repro_torch.launch.analyze import main

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _rules(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------------------
# seeded violations: every SYN rule fires where planted
# ---------------------------------------------------------------------------
BAD_POLL = '''
import numpy as np
import torch
from repro_torch.kernels import ops as kops


class Pool:
    def __init__(self, model, device):
        self.model = model
        self.device = device
        self._counters = torch.zeros(4, dtype=torch.int32, device=device)

    def poll(self):
        out = self.model.decode_step(self.params, self.cache, 0, 0)
        tok = out.argmax().item()              # SYN001
        n = int(self._counters.sum())          # SYN001
        if out.max() > 0:                      # SYN001 (truth test)
            tok += 1
        host = np.asarray(out)                 # SYN002
        arr = out.numpy()                      # SYN002
        torch.cuda.synchronize()               # SYN003
        return tok + n + host.size + arr.size

    def _step_probe(self, x, w):
        ent = kops.exit_head_entropy(x, w)
        return ent.tolist()                    # SYN001
'''

HELPER_SYNC = '''
class Pool:
    def poll(self):
        out = self.model.decode_step(self.params, self.cache, 0, 0)
        return self._first(out)

    def _first(self, out):
        return int(out[0])
'''

EVENT_WAIT = '''
class Pool:
    def poll(self):
        self._done.synchronize()
        self.stream.synchronize()
'''

CLEAN_POLL = '''
import numpy as np
import torch


class Pool:
    def __init__(self, model, device):
        self.model = model
        self.device = device
        self._buf = torch.zeros(4, device=device)
        self.active = np.zeros(4, bool)

    def poll(self):
        if not self.active.any():              # host numpy: no sync
            return 0
        out = self.model.decode_step(self.params, self.cache, 0, 0)
        nxt = out.argmax(-1).cpu().numpy()     # the explicit readback
        also = out.to("cpu").tolist()          # ... and its other spelling
        ring = self._read_ring(self.win)       # laundered by the helper
        if out is None or out.shape[0] > 4 or out.size(0) > 4:
            return -1                          # host metadata
        return int(nxt[0]) + int(ring[0, 0]) + len(also) \\
            + self._commit(ring)

    def _read_ring(self, win):
        return win.ring.read()                 # RingHandle.read

    def _commit(self, ring):
        return int(np.asarray(ring).sum())     # a host array

    def flush(self):
        return self._buf.sum().item()          # not a hot method
'''


def test_syn_rules_fire_on_seeded_violations():
    found = lint_source(BAD_POLL, "bad_poll.py")
    assert _rules(found) == ["SYN001"] * 4 + ["SYN002"] * 2 + ["SYN003"]
    by_line = {f.snippet.split("#")[0].strip(): f.rule for f in found}
    assert by_line["tok = out.argmax().item()"] == "SYN001"
    assert by_line["torch.cuda.synchronize()"] == "SYN003"
    assert by_line["return ent.tolist()"] == "SYN001"
    assert all(f.severity == "error" for f in found)


def test_syn_rule_follows_a_helper_one_level_deep():
    found = lint_source(HELPER_SYNC, "helper.py")
    assert _rules(found) == ["SYN001"]
    assert "[call chain: poll() -> _first()]" in found[0].message


def test_syn003_fires_on_stream_and_event_waits():
    assert _rules(lint_source(EVENT_WAIT, "wait.py")) == ["SYN003"] * 2


def test_legal_readbacks_stay_clean():
    assert lint_source(CLEAN_POLL, "clean.py") == []


def test_a_class_without_poll_is_out_of_scope():
    src = BAD_POLL.replace("def poll(self)", "def serve(self)").replace(
        "def _step_probe", "def probe")
    assert lint_source(src, "nopoll.py") == []


def test_the_repaired_probe_read_fires_in_its_old_form():
    """The segmented step's short-circuit read, before and after its
    repair: ``bool(t.any())`` is an implicit readback, ``bool(t.any()
    .cpu())`` the explicit one (the same token either way)."""
    old = '''
class Sched:
    def poll(self):
        return self.step()

    def _step_segmented(self, tokens, active_d):
        x = self.model.embed_decode_tokens(self.params, tokens)
        alive = self._alive0 & (x.sum() > 0)
        if not bool((alive & active_d).any()):
            return None
        return x
'''
    assert _rules(lint_source(old, "old.py")) == ["SYN001"]
    new = old.replace("(alive & active_d).any()",
                      "(alive & active_d).any().cpu()")
    assert lint_source(new, "new.py") == []


def test_unparseable_file_is_reported():
    found = lint_source("def broken(:\n", "oops.py")
    assert [f.rule for f in found] == ["PARSE"]


# ---------------------------------------------------------------------------
# the CLI and the baseline gate
# ---------------------------------------------------------------------------
def test_analyzer_exits_nonzero_on_seeded_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_POLL)
    empty_baseline = tmp_path / "baseline.json"
    assert main([str(bad), "--baseline", str(empty_baseline)]) == 1
    assert main([str(bad), "--baseline", str(empty_baseline),
                 "--no-gate"]) == 0
    # accepted into a baseline, the same findings no longer gate
    assert main([str(bad), "--baseline", str(empty_baseline),
                 "--update-baseline"]) == 0
    assert main([str(bad), "--baseline", str(empty_baseline)]) == 0


def test_cli_json_lists_the_findings(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(HELPER_SYNC)
    assert main([str(bad), "--baseline", str(tmp_path / "b.json"),
                 "--json", "--no-gate"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in data["findings"]] == ["SYN001"]


def test_port_is_clean_against_committed_baseline():
    findings = lint_paths([os.path.join(REPO, "src", "repro_torch")],
                          repo_root=REPO)
    baseline = load_baseline(os.path.join(REPO,
                                          "analysis_baseline_torch.json"))
    fresh = new_findings(findings, baseline)
    assert fresh == [], "new analyzer violations:\n" + "\n".join(
        f.render() for f in fresh)


def test_cli_lint_alone_passes_on_the_tree(monkeypatch):
    monkeypatch.chdir(REPO)
    assert main(["--no-cost"]) == 0


def test_baseline_gates_only_new_findings(tmp_path):
    old = Finding(rule="SYN001", path="a.py", line=3, col=0,
                  severity="error", message="m", snippet="int(x)")
    new = Finding(rule="SYN001", path="a.py", line=9, col=0,
                  severity="error", message="m", snippet="int(y)")
    bp = str(tmp_path / "b.json")
    save_baseline(bp, [old])
    base = load_baseline(bp)
    # a baselined finding survives a line move (the fingerprint is rule,
    # path and source line)
    moved = Finding(rule="SYN001", path="a.py", line=40, col=0,
                    severity="error", message="m", snippet="int(x)")
    assert new_findings([moved], base) == []
    assert new_findings([moved, new], base) == [new]
    with open(bp) as f:
        assert json.load(f)["findings"][0]["rule"] == "SYN001"


@pytest.mark.parametrize("rid", sorted(RULES))
def test_every_rule_explains_cleanly(rid, capsys):
    assert main(["--explain", rid]) == 0
    out = capsys.readouterr().out
    assert rid in out
    assert RULES[rid].description.split()[0] in out
    assert "violates:" in out and "fix:" in out


def test_unknown_rule_does_not_explain(capsys):
    assert main(["--explain", "NOPE99"]) == 2
    assert "known:" in capsys.readouterr().err


def test_jax_only_rule_families_are_not_registered():
    assert {r[:3] for r in RULES} == {"CST", "PAR", "SYN"}


def test_corrupt_baseline_error_is_actionable(tmp_path):
    bad = tmp_path / "analysis_baseline_torch.json"
    bad.write_text('{"findings": [')
    with pytest.raises(ValueError) as e:
        load_baseline(str(bad))
    assert str(bad) in str(e.value)
    assert "--update-baseline" in str(e.value)
