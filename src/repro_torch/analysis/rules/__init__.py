"""Rule registry of the port's serving-stack analyzer.

Each rule has a stable id (referenced by the baseline and the tests), a
severity, a one-line description, and, for ``--explain``, a minimal
violating snippet plus its fix.  The ids are grouped:

* ``SYN***``: host syncs in the serving poll hot loop.  The methods of a
  class that defines ``poll`` (``poll``/``step``/``tick``/
  ``prefill_poll`` and the ``_step*``/``_poll*``/``_dispatch*``/
  ``_commit*`` helpers, and the same-class helpers they call) must not
  read a device value back implicitly; the legal readbacks are explicit:
  ``.cpu()`` (or ``.to("cpu")``) and ``RingHandle.read()``, the async
  window's one ring wait.
* ``CST***``: cost-graph honesty: the registered decode stages' matmul
  FLOPs against the analytic per-token cost the admission router prices
  with (``analysis/costcheck.py``).

The reference's other families are not registered, as they have no
meaning in eager PyTorch: TRC and IPC (concretization inside a jit trace:
nothing is traced here), PLT (Pallas tile and grid legality: the kernels
are CUDA C++), and JXP001-JXP003 (callbacks, uploads and folded constants
inside a jaxpr: a stage is Python, and its host work is the SYN rules').
JXP004 and JXP005 (a cache's dtype and in-place reuse) live on as runtime
checks of ``guards.no_recompile``: a captured graph's cache leaves keep
their address, dtype and shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    severity: str                      # "error" | "warning"
    description: str
    example: str = ""                  # minimal violating snippet
    fix: str = ""                      # how to repair it


_ALL = [
    Rule("CST001", "cost-graph-drift", "error",
         "registered decode stages' matmul FLOPs per token drifted outside "
         "the committed tolerance band around the analytic cost the "
         "admission router prices with: tier routing decisions are no "
         "longer grounded in what the stages actually compute",
         example="# core/cost_model._layer_flops drops the FFN term while\n"
                 "# the decode segments still run it",
         fix="re-derive core/cost_model._layer_flops for the changed "
             "architecture (or widen analysis/costcheck.TOLERANCE with a "
             "written justification beside it)"),
    Rule("SYN001", "poll-implicit-readback", "error",
         ".item()/.tolist()/int()/float()/bool() or a truth test on a "
         "device tensor inside a poll hot method: a hidden per-call device "
         "sync that serializes the overlapped decode pipeline",
         example="class Pool:\n    def poll(self):\n        out = self."
                 "model.decode_step(self.params, self.cache, t, p)\n"
                 "        return out.argmax().item()",
         fix="defer the readback and batch it: tok = int(out.argmax()."
             "cpu()) at the ONE intended sync point per step or window"),
    Rule("SYN002", "poll-host-numpy-sync", "error",
         ".numpy()/np.asarray()/np.array() on a device value inside a poll "
         "hot method that no explicit readback reached first: a hidden "
         "blocking transfer (on the card .numpy() of a device tensor "
         "raises, np.asarray syncs)",
         example="class Pool:\n    def poll(self):\n        out = self."
                 "model.decode_step(self.params, self.cache, t, p)\n"
                 "        return np.asarray(out)",
         fix="make the readback explicit and batched: out.cpu().numpy(), "
             "or RingHandle.read() for an async window's ring"),
    Rule("SYN003", "poll-synchronize", "error",
         "torch.cuda.synchronize(), or .synchronize() on a stream or event, "
         "inside a poll hot method stalls the host on every dispatch; the "
         "only legal wait is RingHandle.read's event wait behind the ring "
         "copy",
         example="class Pool:\n    def poll(self):\n        out = self."
                 "model.decode_step(self.params, self.cache, t, p)\n"
                 "        torch.cuda.synchronize()",
         fix="drop the barrier from the hot loop: the explicit readback "
             "(.cpu() or RingHandle.read()) already waits for what it "
             "reads (benchmarks may synchronize OUTSIDE poll)"),
    Rule("PARSE", "unparseable-file", "error",
         "file failed to parse; the analyzer cannot vouch for it",
         example="def broken(:",
         fix="fix the syntax error; the analyzer skips nothing it cannot "
             "parse"),
]

RULES: Dict[str, Rule] = {r.id: r for r in _ALL}
