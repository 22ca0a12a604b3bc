"""Sealed-object immutability pass (static half of the write sanitizer).

The port's copy of ``repro.analysis.rules_sealed``, taught the port's
tensor idiom. Sealed objects (``DataObject``/``TombstoneObject``) are
immutable by contract: zone maps, signature carries, the visibility/delta
caches, and replay determinism all assume a sealed lane never changes.
The runtime half (``REPRO_SANITIZE=1``) swaps every sealed tensor lane for
an inference-mode copy at seal, store and fault-in time, which refuses
in-place ops with ``RuntimeError``; this pass catches the writes
statically, including through local aliases::

    arr = obj.cols["v"]          # alias of a sealed lane
    arr[3] = 0.0                 # flagged (taint-tracked)
    obj.key_lo[i] = sig          # flagged (direct)
    obj.key_lo.view(-1).add_(1)  # flagged (in-place tensor method)
    lane.setflags(write=True)    # flagged (un-freezing a numpy lane)
    with torch.inference_mode(): # flagged (re-arms writes on the
        ...                      #  sanitizer's inference-mode lanes)

Alias tracking is intra-function and deliberately conservative: taint
propagates through views — subscripts, numpy's ``.view``/``.reshape``/
``.ravel``/``.squeeze``/``.transpose`` and torch's ``view``, ``reshape``,
``flatten``, ``narrow``, ``select``, ``squeeze``, ``unsqueeze``, ``t``,
``transpose``, ``permute``, ``expand``, and the calls that may return
their receiver's storage (``contiguous``, ``detach``, ``numpy``) — and
dies at allocating calls (``.copy()``, ``.clone()``, ``np.concatenate``,
``torch.cat``, arithmetic), so rebinding a lane into a fresh array stays
clean. Mutators are numpy's in-place methods and every tensor method
whose name ends in ``_`` (``copy_``, ``fill_``, ``zero_``,
``index_put_``, ``scatter_``, ``add_``, ...).

The port's sanitizer has exactly one way to re-arm writes on a frozen
lane: an in-place op inside ``torch.inference_mode()`` is allowed on an
inference tensor. So entering inference mode is flagged as
``setflags(write=True)`` is; the freeze itself, which clones into an
inference tensor inside that mode, carries a reasoned pragma.
"""
from __future__ import annotations

import ast
from typing import List, Set

from .base import Finding, LintModule, Rule, call_chain, keyword_arg

#: attribute names that are sealed-object lanes
SEALED_ATTRS = frozenset({
    "cols", "commit_ts", "row_lo", "row_hi", "key_lo", "key_hi",
    "lob_sigs", "target",
})

#: methods that return a VIEW of their receiver, or may return the
#: receiver's own storage (taint flows through): numpy's and torch's
_VIEW_METHODS = frozenset({
    "view", "reshape", "ravel", "squeeze", "transpose",
    "flatten", "narrow", "select", "unsqueeze", "t", "permute", "expand",
    "contiguous", "detach", "numpy",
})

#: ndarray methods that mutate their receiver in place (every tensor
#: method whose name ends in ``_`` does too)
_MUTATORS = frozenset({"fill", "sort", "partition", "put", "itemset",
                       "byteswap"})


def _is_mutator(name: str) -> bool:
    return name in _MUTATORS or (name.endswith("_")
                                 and not name.startswith("_"))


def _taints(expr: ast.AST, tainted: Set[str]) -> bool:
    """Does ``expr`` evaluate to (a view of) a sealed lane?"""
    if isinstance(expr, ast.Attribute):
        return expr.attr in SEALED_ATTRS
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Subscript):
        return _taints(expr.value, tainted)
    if isinstance(expr, ast.Call):
        if (isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _VIEW_METHODS):
            return _taints(expr.func.value, tainted)
        return False
    return False


def _rearms_inference(call: ast.Call, chain: List[str]) -> bool:
    """``torch.inference_mode()`` / ``(True)``: in-place writes to the
    sanitizer's inference-mode lanes are allowed inside it (``(False)``
    turns the mode off and re-arms nothing)."""
    if chain[-1] != "inference_mode" or chain[0] != "torch":
        return False      # (a one-name chain has chain[0] == chain[-1])
    mode = call.args[0] if call.args else keyword_arg(call, "mode")
    return not (isinstance(mode, ast.Constant) and mode.value is False)


class SealedWriteRule(Rule):
    id = "sealed-write"
    pragma = "seal-ok"
    doc = ("in-place writes to sealed-object lanes (cols/commit_ts/row_*/"
           "key_*/lob_sigs/target), including through local aliases and "
           "in-place tensor methods, setflags(write=True) un-freezing, and "
           "torch.inference_mode() re-arming")

    def check(self, mod: LintModule, project) -> List[Finding]:
        if mod.tree is None:
            return []
        out: List[Finding] = []
        scopes = [n for n in ast.walk(mod.tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        scopes.append(mod.tree)
        seen: Set[int] = set()
        for scope in scopes:
            tainted: Set[str] = set()
            for dec in getattr(scope, "decorator_list", ()):
                self._check_expr(mod, dec, tainted, out, seen)
            body = scope.body if hasattr(scope, "body") else []
            for stmt in body:
                self._visit_stmt(mod, stmt, tainted, out, seen)
        return out

    def _visit_stmt(self, mod, stmt, tainted, out, seen) -> None:
        # statement-order walk so aliases are bound before their writes
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                self._check_store(mod, t, stmt.value, tainted, out, seen)
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    if _taints(stmt.value, tainted):
                        tainted.add(t.id)
                    else:
                        tainted.discard(t.id)
        elif isinstance(stmt, ast.AugAssign):
            self._check_store(mod, stmt.target, stmt.value, tainted, out,
                              seen)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                      # nested scope handled separately
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.stmt):
                self._visit_stmt(mod, sub, tainted, out, seen)
            elif isinstance(sub, ast.ExceptHandler):
                for s in sub.body:
                    self._visit_stmt(mod, s, tainted, out, seen)
            elif isinstance(sub, ast.withitem):
                self._check_expr(mod, sub.context_expr, tainted, out, seen)
            elif isinstance(sub, ast.expr):
                self._check_expr(mod, sub, tainted, out, seen)

    def _check_store(self, mod, target, value, tainted, out, seen) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_store(mod, elt, value, tainted, out, seen)
            return
        if isinstance(target, ast.Subscript) and id(target) not in seen \
                and _taints(target.value, tainted):
            seen.add(id(target))
            out.append(self.finding(
                mod, target,
                "in-place write into a sealed-object lane "
                "(REPRO_SANITIZE=1 raises here at runtime)",
                "build a fresh array and seal a new object — sealed "
                "lanes are immutable; or justify with "
                "`# lint: seal-ok <reason>`"))

    def _check_expr(self, mod, expr, tainted, out, seen) -> None:
        for sub in ast.walk(expr):
            if not isinstance(sub, ast.Call) or id(sub) in seen:
                continue
            # the method's name also where its receiver is itself a call
            # (``lane.view(-1).add_(1)``), which has no pure name chain
            chain = call_chain(sub) or (
                [sub.func.attr] if isinstance(sub.func, ast.Attribute)
                else [])
            if not chain:
                continue
            if chain[-1] == "setflags":
                for kw in sub.keywords:
                    if (kw.arg == "write"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True):
                        seen.add(id(sub))
                        out.append(self.finding(
                            mod, sub,
                            "setflags(write=True) re-arms writes on an "
                            "array — defeats the sealed-lane sanitizer"))
            elif _rearms_inference(sub, chain):
                seen.add(id(sub))
                out.append(self.finding(
                    mod, sub,
                    "torch.inference_mode() re-arms in-place writes on "
                    "inference-mode tensors — defeats the sealed-lane "
                    "sanitizer"))
            elif (_is_mutator(chain[-1])
                    and isinstance(sub.func, ast.Attribute)
                    and _taints(sub.func.value, tainted)):
                seen.add(id(sub))
                out.append(self.finding(
                    mod, sub,
                    f".{chain[-1]}() mutates a sealed-object lane in "
                    "place"))
