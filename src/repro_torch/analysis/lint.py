"""AST lint pass: host syncs in the port's serving poll hot loop.

The analyzer is purely static: it never imports the code under analysis.
Per module, for every class that defines ``poll()`` (the scheduler, the
pools, the cluster):

1. **Device state**: ``self.x`` attributes assigned anywhere in the class
   from a device value (the cache, the exit counters, the persistent
   buffers) are device values in every method.
2. **Taint walk** of each hot method (``poll``/``step``/``tick``/
   ``prefill_poll`` and the ``_step*``/``_poll*``/``_dispatch*``/
   ``_commit*`` helpers).  Device values are the outputs of the model's
   methods (``self.model.*``) and of the kernel wrappers (``kops.*``),
   tensors made with a ``device=`` or moved by ``.to(device)`` /
   ``.cuda()``, and whatever is computed from them.  ``.cpu()``,
   ``.to("cpu")`` and ``RingHandle.read()`` (``<x>.ring.read()``) are the
   explicit readbacks: they launder the value.  Shape and dtype access
   (``.shape``, ``.size()``, ...) is host metadata.
3. **Helpers one level deep**: a call ``self._h(...)`` from a hot method
   re-enters ``_h`` with the tainted arguments mapped onto its parameters
   (``callgraph.py``); a hazard there is reported with the call chain, and
   a helper whose return is a readback (``_read_ring``,
   ``_spec_readback``) returns a host value.

The SYN rules fire on implicit readbacks of a device value (``.item()``,
``.tolist()``, ``int()``/``float()``/``bool()``, a truth test: SYN001;
``.numpy()``, ``np.*``: SYN002) and on any ``synchronize()`` (SYN003).
Anything unresolvable is left alone, never guessed.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.callgraph import (MAX_CHAIN_DEPTH, CallGraph,
                                            FuncNode, format_chain,
                                            func_display_name,
                                            map_tainted_params)
from repro_torch.analysis.report import Finding, sort_findings
from repro_torch.analysis.rules import RULES

_FUNC_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# attribute access and methods that yield host metadata, not device data
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                 "requires_grad"}
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "data_ptr", "is_contiguous", "stride", "get_device"}
_NUMPY_ALIASES = {"np", "numpy", "onp"}
# builtins whose result is a host value (int/float/bool are the SYN001
# conversions, checked on their own)
_HOST_BUILTINS = {"len", "isinstance", "range", "zip", "enumerate", "list",
                  "tuple", "dict", "set", "sorted", "min", "max", "sum", "abs",
                  "id", "print", "str", "repr", "hasattr", "getattr", "iter",
                  "next", "type", "any", "all", "int", "float", "bool"}
# poll-hot-loop method names: the round entry points plus their
# dispatch/commit helpers
_HOT_METHOD_NAMES = {"poll", "step", "tick", "prefill_poll"}
_HOT_METHOD_PREFIXES = ("_step", "_poll", "_dispatch", "_commit")
_KERNEL_MODULE = ("repro_torch.kernels", "ops")


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name: ``torch.cuda.synchronize`` etc."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_hot(name: str) -> bool:
    return name in _HOT_METHOD_NAMES or name.startswith(_HOT_METHOD_PREFIXES)


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _is_device_expr(node: ast.AST) -> bool:
    """A ``.to()`` / ``device=`` argument naming a device other than the
    CPU: ``self.device``, ``dev``, ``x.device``, ``"cuda"``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value != "cpu"
    d = _dotted(node)
    return d in ("dev", "device") or d.endswith(".device")


def _kernel_aliases(tree: ast.Module) -> Set[str]:
    """Names the module binds to ``repro_torch.kernels.ops``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) \
                and node.module == _KERNEL_MODULE[0]:
            for a in node.names:
                if a.name == _KERNEL_MODULE[1]:
                    out.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == ".".join(_KERNEL_MODULE) and a.asname:
                    out.add(a.asname)
    return out


class ModuleLinter:
    """Lints one parsed module."""

    def __init__(self, tree: ast.Module, source: str, path: str):
        self.tree = tree
        self.lines = source.splitlines()
        self.path = path
        self.findings: List[Finding] = []
        self._emitted: Set[Tuple[str, int, int]] = set()
        self.kernel_aliases = _kernel_aliases(tree)
        defs: Dict[str, List[FuncNode]] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, []).append(node)
        self.callgraph = CallGraph(defs)

    def _snippet(self, node: ast.AST) -> str:
        ln = getattr(node, "lineno", 0)
        if 1 <= ln <= len(self.lines):
            return self.lines[ln - 1].strip()
        return ""

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        key = (rule, getattr(node, "lineno", 0),
               getattr(node, "col_offset", 0))
        if key in self._emitted:
            return
        self._emitted.add(key)
        meta = RULES[rule]
        self.findings.append(Finding(
            rule=rule, path=self.path, line=key[1], col=key[2],
            severity=meta.severity, message=f"[{meta.name}] {message}",
            snippet=self._snippet(node)))

    # -- the poll-sync pass --------------------------------------------------
    def check_poll_sync(self) -> None:
        for cls in ast.walk(self.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            if not any(m.name == "poll" for m in methods):
                continue
            names = {m.name for m in methods}
            dev: Set[str] = set()
            for _ in range(2):                 # attrs set from attrs
                for m in methods:
                    w = _PollSyncWalker(self, m, dev, names, report=False)
                    w.run()
                    dev |= w.dev
            visited: Set[Tuple[int, frozenset]] = set()
            for m in methods:
                if _is_hot(m.name):
                    _PollSyncWalker(self, m, dev, names, report=True,
                                    visited=visited).run()

    def run(self) -> List[Finding]:
        self.check_poll_sync()
        return self.findings


class _PollSyncWalker:
    """Walks one method, tracking which values are device values, and
    (``report``) fires the SYN rules on implicit readbacks.  ``chain`` is
    the call chain when the walk re-entered a helper from a hot method."""

    def __init__(self, linter: ModuleLinter, fn: FuncNode, dev_attrs: Set[str],
                 methods: Set[str], *, report: bool,
                 chain: Tuple[str, ...] = (),
                 tainted: Optional[Set[str]] = None,
                 visited: Optional[Set[Tuple[int, frozenset]]] = None):
        self.linter = linter
        self.fn = fn
        self.methods = methods
        self.report = report
        self.chain = chain or (func_display_name(fn),)
        self.dev = set(dev_attrs)          # dotted self.x device state
        self.tainted: Set[str] = set(tainted or ())   # local device names
        self.models: Set[str] = {"self.model"}        # model handles
        self.visited = visited if visited is not None else set()
        self.returns_device = False

    # taintedness of an expression ------------------------------------------
    def _tainted(self, expr: Optional[ast.AST]) -> bool:
        if expr is None:
            return False
        if isinstance(expr, ast.Call):
            return self._call_tainted(expr)
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS:
                return False
            if _dotted(expr) in self.dev:
                return True
            return self._tainted(expr.value)
        if isinstance(expr, ast.Name):
            return expr.id in self.tainted
        if isinstance(expr, ast.Subscript):
            return self._tainted(expr.value)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops):
                return False
            return self._tainted(expr.left) \
                or any(self._tainted(c) for c in expr.comparators)
        if isinstance(expr, ast.IfExp):
            return self._tainted(expr.body) or self._tainted(expr.orelse)
        if isinstance(expr, _FUNC_TYPES):
            return False
        return any(self._tainted(c) for c in ast.iter_child_nodes(expr))

    def _call_tainted(self, call: ast.Call) -> bool:
        func = call.func
        d = _dotted(func)
        if _is_readback(call):
            return False                   # explicit readback launders
        name = func.attr if isinstance(func, ast.Attribute) else d
        if name.lstrip("_")[:1].isupper():
            return False                   # a constructor: a host object
        kw = {k.arg: k.value for k in call.keywords}
        if "device" in kw and _is_device_expr(kw["device"]):
            return True                    # made on the device
        if isinstance(func, ast.Attribute):
            root = d.split(".", 1)[0] if d else ""
            if d and (d.rsplit(".", 1)[0] in self.models
                      or root in self.linter.kernel_aliases):
                return True                # model method / kernel wrapper
            if root in _NUMPY_ALIASES:
                return False               # host numpy (SYN002 if tainted)
            if func.attr == "cuda" or (func.attr == "to" and any(
                    _is_device_expr(a) for a in call.args)):
                return True
            if func.attr in _STATIC_METHODS:
                return False
            if isinstance(func.value, ast.Name) \
                    and func.value.id in ("self", "cls") \
                    and func.attr in self.methods:
                return self._helper_returns_device(call)
            if self._tainted(func.value):
                return True                # a method of a device value
        elif isinstance(func, ast.Name) and func.id in _HOST_BUILTINS:
            return False
        return any(self._tainted(a) for a in call.args) \
            or any(self._tainted(k.value) for k in call.keywords)

    def _helper_returns_device(self, call: ast.Call) -> bool:
        """A same-class helper's return, walked one level deep with the
        call's tainted arguments; deeper, any tainted argument taints."""
        if len(self.chain) > MAX_CHAIN_DEPTH:
            return any(self._tainted(a) for a in call.args) \
                or any(self._tainted(k.value) for k in call.keywords)
        out = False
        for helper in self.linter.callgraph.resolve_call(call):
            params = map_tainted_params(call, helper, self._tainted)
            if params is None:
                return True
            w = _PollSyncWalker(self.linter, helper, self.dev, self.methods,
                                report=False,
                                chain=self.chain + (func_display_name(helper),),
                                tainted=params)
            w.run()
            out = out or w.returns_device
        return out

    def _taint_target(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._taint_target(el, tainted)
            return
        if isinstance(target, ast.Starred):
            self._taint_target(target.value, tainted)
            return
        d = _dotted(target)
        if d.startswith("self."):
            if tainted:
                self.dev.add(d)
        elif isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, ast.Subscript) and tainted:
            self._taint_target(target.value, tainted)

    def _assign(self, targets: Sequence[ast.AST], value: ast.AST) -> None:
        """Bind targets, element-wise when both sides are tuples."""
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)) \
                    and isinstance(value, (ast.Tuple, ast.List)) \
                    and len(t.elts) == len(value.elts):
                for te, ve in zip(t.elts, value.elts):
                    self._assign([te], ve)
                continue
            if isinstance(t, ast.Name) and _dotted(value) in self.models:
                self.models.add(t.id)
            self._taint_target(t, self._tainted(value))

    # walk -------------------------------------------------------------------
    def run(self) -> None:
        for stmt in self.fn.body:
            self._walk(stmt)

    def _walk(self, node: ast.AST) -> None:
        if isinstance(node, _FUNC_TYPES):
            return                         # nested defs: out of scope
        if isinstance(node, ast.Assign):
            self._walk(node.value)
            self._assign(node.targets, node.value)
            return
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if node.value is not None:
                self._walk(node.value)
                if self._tainted(node.value):
                    self._taint_target(node.target, True)
            return
        if isinstance(node, ast.Return):
            if node.value is not None:
                self._walk(node.value)
                self.returns_device |= self._tainted(node.value)
            return
        if isinstance(node, (ast.If, ast.While, ast.Assert)):
            self._truth_test(node.test)
        elif isinstance(node, ast.IfExp):
            self._truth_test(node.test)
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            self._truth_test(node.operand)
        elif isinstance(node, ast.Call):
            self._check_call(node)
        for child in ast.iter_child_nodes(node):
            self._walk(child)

    def _where(self) -> str:
        if len(self.chain) > 1:
            return (f"in poll hot path [call chain: "
                    f"{format_chain(self.chain)}]")
        return f"in poll hot method '{func_display_name(self.fn)}'"

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if self.report:
            self.linter.emit(rule, node, message)

    def _truth_test(self, test: ast.AST) -> None:
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                self._truth_test(v)
            return
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test = test.operand
        if self._tainted(test):
            self._emit("SYN001", test,
                       f"truth test of a device tensor {self._where()}: a "
                       f"hidden per-call device sync (read it back with "
                       f".cpu() at the intended sync point)")

    def _check_call(self, call: ast.Call) -> None:
        func = call.func
        where = self._where()
        self._follow(call)
        if isinstance(func, ast.Name):
            if func.id in ("int", "float", "bool") \
                    and any(self._tainted(a) for a in call.args):
                self._emit(
                    "SYN001", call,
                    f"{func.id}() on a device tensor {where}: hidden "
                    f"per-call device sync (read it back with .cpu() at "
                    f"the batched readback point)")
            return
        if not isinstance(func, ast.Attribute):
            return
        d = _dotted(func)
        if func.attr in ("item", "tolist") and self._tainted(func.value):
            self._emit(
                "SYN001", call,
                f".{func.attr}() on a device tensor {where}: hidden "
                f"per-call device sync (defer to the batched readback)")
            return
        if func.attr == "synchronize" or d == "torch.cuda.synchronize":
            self._emit(
                "SYN003", call,
                f"{d or func.attr}() {where} stalls the host per dispatch: "
                f"the explicit readback already waits for what it reads")
            return
        if func.attr == "numpy" and self._tainted(func.value):
            self._emit(
                "SYN002", call,
                f".numpy() on a device tensor {where} without an explicit "
                f"readback (.cpu() first)")
            return
        root = d.split(".", 1)[0] if d else ""
        if root in _NUMPY_ALIASES \
                and any(self._tainted(a) for a in call.args):
            self._emit(
                "SYN002", call,
                f"{d}() on a device tensor {where} without an explicit "
                f"readback: hidden blocking transfer (use x.cpu().numpy() "
                f"at the readback boundary)")

    def _follow(self, call: ast.Call) -> None:
        """Re-enter a non-hot same-class helper one level deep."""
        if not self.report or len(self.chain) > MAX_CHAIN_DEPTH:
            return
        func = call.func
        if not (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id in ("self", "cls")
                and func.attr in self.methods and not _is_hot(func.attr)):
            return
        for helper in self.linter.callgraph.resolve_call(call):
            params = map_tainted_params(call, helper, self._tainted)
            if params is None:
                continue
            key = (id(helper), frozenset(params))
            if key in self.visited:
                continue
            self.visited.add(key)
            _PollSyncWalker(self.linter, helper, self.dev, self.methods,
                            report=True,
                            chain=self.chain + (func_display_name(helper),),
                            tainted=params, visited=self.visited).run()


def _is_readback(call: ast.Call) -> bool:
    """``x.cpu()``, ``x.to("cpu")`` / ``x.to(device="cpu")`` and
    ``<x>.ring.read()`` (``RingHandle.read``)."""
    func = call.func
    if not isinstance(func, ast.Attribute):
        return False
    if func.attr == "cpu":
        return True
    if func.attr == "to":
        return any(_is_cpu(a) for a in call.args) \
            or any(k.arg == "device" and _is_cpu(k.value)
                   for k in call.keywords)
    if func.attr == "read":
        d = _dotted(func.value)
        return d == "ring" or d.endswith(".ring")
    return False


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        meta = RULES["PARSE"]
        return [Finding(rule="PARSE", path=path, line=e.lineno or 0,
                        col=e.offset or 0, severity=meta.severity,
                        message=f"[{meta.name}] {e.msg}")]
    return sort_findings(ModuleLinter(tree, source, path).run())


def lint_file(path: str, repo_root: Optional[str] = None) -> List[Finding]:
    rel = os.path.relpath(path, repo_root) if repo_root else path
    rel = rel.replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    return lint_source(source, rel)


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        yield os.path.join(root, fn)


def lint_paths(paths: Sequence[str], repo_root: Optional[str] = None
               ) -> List[Finding]:
    findings: List[Finding] = []
    for fp in iter_python_files(paths):
        findings.extend(lint_file(fp, repo_root))
    return sort_findings(findings)
