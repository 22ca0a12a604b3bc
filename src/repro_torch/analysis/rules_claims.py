"""Sortedness/carry-claim passes: the producer rules.

The port's copy of ``repro.analysis.rules_claims``, keyed to
``repro_torch.*``. A ``runs=`` claim on a :class:`SignedStream`/
:class:`SigBatch`, a ``presorted=True`` seal, or a ``sigs=`` carry into
``Txn.insert`` is a *promise* the engine will not re-verify on the hot
path — a false claim seals misordered objects and corrupts every later
probe. The reviewed producer set lives in ``PRODUCER_MODULES``; any claim
elsewhere needs a ``# lint: runs-ok <reason>`` justification.

The companion pass flags ``sort``/``lexsort``/``unique``/``argsort`` called
through numpy (``np.``/``numpy.``) or torch (``torch.``, the port's array
calls) in the hot-path modules: the zero-rehash design exists to keep
sorts out of apply/diff, so a new sort there is a latent perf regression
until justified (``# lint: sort-ok <reason>``). The finding names the call
as written (``torch.unique``, ``np.lexsort``).
"""
from __future__ import annotations

import ast
from typing import List

from .base import (Finding, LintModule, Rule, call_chain, is_none,
                   keyword_arg)

#: modules whose carry/sortedness claims were reviewed with the reference's
#: (the same modules under ``repro_torch.``) — every producer here is
#: covered by the side-by-side carry tests
PRODUCER_MODULES = frozenset({
    "repro_torch.core.sigs", "repro_torch.core.objects",
    "repro_torch.core.delta", "repro_torch.core.diff",
    "repro_torch.core.merge", "repro_torch.core.table",
    "repro_torch.core.engine", "repro_torch.core.workspace",
    "repro_torch.core.compaction", "repro_torch.core.indices",
    # pack decode reconstructs sealed objects lane-for-lane from
    # digest-verified blobs — the lanes were sorted when sealed, and the
    # content address pins them bit-for-bit
    "repro_torch.store.packs",
})

#: hot-path modules where a hidden sort undoes the zero-rehash wins
HOT_MODULES = frozenset({
    "repro_torch.core.delta", "repro_torch.core.merge",
    "repro_torch.core.engine", "repro_torch.kernels.ops",
    "repro_torch.kernels.probe", "repro_torch.distributed.sharding",
})

_SORT_FNS = frozenset({"sort", "lexsort", "unique", "argsort"})

#: the array modules whose sorts the hidden-sort pass sees: numpy's and
#: torch's (the port's lanes are tensors)
_ARRAY_MODULES = frozenset({"np", "numpy", "torch"})


class SortedClaimsRule(Rule):
    id = "sorted-claims"
    pragma = "runs-ok"
    doc = ("sortedness/carry claims (SignedStream(runs=...), SigBatch, "
           "seal_data_object(presorted=True), Txn.insert(sigs=...)) outside "
           "the reviewed producer modules need a justification pragma")

    def check(self, mod: LintModule, project) -> List[Finding]:
        if mod.tree is None or mod.module in PRODUCER_MODULES:
            return []
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = call_chain(node)
            tail = chain[-1] if chain else ""
            if tail == "SignedStream":
                runs = keyword_arg(node, "runs")
                if runs is not None and not is_none(runs):
                    out.append(self.finding(
                        mod, node,
                        "SignedStream constructed with a runs= sortedness "
                        "claim outside the reviewed producer modules",
                        "emit runs=None (consumer will sort) or justify "
                        "with `# lint: runs-ok <why the order is real>`"))
            elif tail == "SigBatch":
                runs = keyword_arg(node, "runs")
                claims = ((runs is not None and not is_none(runs))
                          or len(node.args) >= 6)
                if claims:
                    out.append(self.finding(
                        mod, node,
                        "SigBatch constructed with a runs= sortedness claim "
                        "outside the reviewed producer modules"))
            elif chain[-2:] == ["SigBatch", "sorted_run"]:
                out.append(self.finding(
                    mod, node,
                    "SigBatch.sorted_run() claims a single key-sorted run "
                    "outside the reviewed producer modules"))
            elif tail == "seal_data_object":
                pre = keyword_arg(node, "presorted")
                if isinstance(pre, ast.Constant) and pre.value is True:
                    out.append(self.finding(
                        mod, node,
                        "seal_data_object(presorted=True) skips the seal "
                        "sort on an unreviewed path",
                        "drop presorted (the seal will lexsort) or justify "
                        "with `# lint: runs-ok <why rows arrive sorted>`"))
            elif tail == "insert":
                sigs = keyword_arg(node, "sigs")
                if sigs is not None and not is_none(sigs):
                    out.append(self.finding(
                        mod, node,
                        "Txn.insert(..., sigs=...) carries signatures the "
                        "engine will not rehash, from an unreviewed module",
                        "drop sigs= (the engine rehashes) or justify with "
                        "`# lint: runs-ok <where the sigs come from>`"))
        return out


class HiddenSortRule(Rule):
    id = "hidden-sort"
    pragma = "sort-ok"
    doc = ("np./torch. sort/lexsort/unique/argsort in the hot-path "
           "modules (delta, merge, ops, engine, probe, sharding) is a "
           "zero-rehash regression until justified")

    def check(self, mod: LintModule, project) -> List[Finding]:
        if mod.tree is None or mod.module not in HOT_MODULES:
            return []
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = call_chain(node)
            if (len(chain) >= 2 and chain[0] in _ARRAY_MODULES
                    and chain[-1] in _SORT_FNS):
                out.append(self.finding(
                    mod, node,
                    f"{'.'.join(chain)} in hot-path module {mod.module} — "
                    "hidden sort on a zero-rehash path",
                    "carry runs/signatures instead of re-sorting, or "
                    "justify with `# lint: sort-ok <why this path must "
                    "sort>`"))
        return out
