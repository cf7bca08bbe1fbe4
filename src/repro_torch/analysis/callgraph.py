"""Module-level call graph for the poll-sync lint's helper following.

The per-method walk in :mod:`repro_torch.analysis.lint` sees one hot
method at a time, so a readback moved into a helper escapes it::

    class Pool:
        def poll(self):
            out = self.model.decode_step(...)
            return self._first(out)     # looks clean from here

        def _first(self, out):
            return int(out[0])          # the sync lives here

``CallGraph`` resolves call sites to *same-module* function defs (bare
names and ``self._method`` / ``cls._method`` attributes, the repo's two
helper idioms), and ``map_tainted_params`` translates a call's tainted
arguments into the callee's tainted parameter names.  The walker then
re-enters the helper with exactly that taint set and the call chain, one
level deep; what it finds there is reported with the chain.  A helper
whose return is a readback (``.cpu()``, ``RingHandle.read()``) launders
the value it returns.

Resolution is deliberately conservative: only defs of the module under
analysis are candidates, and ``*args`` / ``**kwargs`` at the call site
bail out.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Set, Union

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

# how deep a helper chain is followed from a hot method
MAX_CHAIN_DEPTH = 1


def func_display_name(fn: FuncNode) -> str:
    if isinstance(fn, ast.Lambda):
        return "<lambda>"
    return fn.name


def format_chain(chain) -> str:
    return " -> ".join(f"{name}()" for name in chain)


class CallGraph:
    """Call-site resolution over one module's function defs."""

    def __init__(self, defs_by_name: Dict[str, List[FuncNode]]):
        self.defs_by_name = defs_by_name

    def resolve_call(self, call: ast.Call) -> List[FuncNode]:
        """Same-module defs a call may dispatch to ([] when unresolvable
        or when the target lives in another module)."""
        func = call.func
        if isinstance(func, ast.Name):
            return list(self.defs_by_name.get(func.id, []))
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id in ("self", "cls"):
            return list(self.defs_by_name.get(func.attr, []))
        return []


def map_tainted_params(call: ast.Call, fn: FuncNode,
                       is_tainted: Callable[[ast.AST], bool]
                       ) -> Optional[Set[str]]:
    """Callee parameter names that receive a tainted argument at this call
    site.  ``None`` means the mapping is ambiguous (splatted arguments) and
    the call must not be followed."""
    a = fn.args
    if any(isinstance(arg, ast.Starred) for arg in call.args) \
            or any(kw.arg is None for kw in call.keywords):
        return None
    positional = [p.arg for p in a.posonlyargs + a.args]
    # a bound-method call (self.f(...) / cls.f(...)) consumes the first
    # positional parameter implicitly
    if isinstance(call.func, ast.Attribute) and positional \
            and positional[0] in ("self", "cls"):
        positional = positional[1:]
    tainted: Set[str] = set()
    for i, arg in enumerate(call.args):
        if not is_tainted(arg):
            continue
        if i < len(positional):
            tainted.add(positional[i])
        elif a.vararg is not None:
            tainted.add(a.vararg.arg)
        else:
            return None                # arity mismatch: don't guess
    kwnames = set(positional) | {p.arg for p in a.kwonlyargs}
    for kw in call.keywords:
        if not is_tainted(kw.value):
            continue
        if kw.arg in kwnames:
            tainted.add(kw.arg)
        elif a.kwarg is not None:
            tainted.add(a.kwarg.arg)
        else:
            return None
    return tainted
