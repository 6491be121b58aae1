"""Job diffs for `job plan` dry-runs.

Reference behavior: nomad/structs/diff.go (~1.4k LoC): JobDiff with
Type in {None, Added, Deleted, Edited}, flat field diffs, nested object
diffs, per-task-group and per-task breakdowns. Here a generic dataclass
walker produces the same shape; field names render in the wire form the
API uses (codec.wire_name).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

DIFF_NONE = "None"
DIFF_ADDED = "Added"
DIFF_DELETED = "Deleted"
DIFF_EDITED = "Edited"

# job fields that change on every registration and carry no spec meaning
_IGNORED_FIELDS = {
    "create_index", "modify_index", "job_modify_index", "version",
    "submit_time_ns", "status", "status_description", "stable",
}


def _wire(name: str) -> str:
    from nomad_tpu_torch.api.codec import wire_name

    return wire_name(name)


def _scalar(v: Any) -> bool:
    return v is None or isinstance(v, (str, int, float, bool, bytes))


def _fmt(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def field_diffs(old: Any, new: Any, prefix: str = "") -> List[Dict]:
    """Flat field diffs between two same-type dataclasses (diff.go
    fieldDiffs). Nested dataclasses/collections are handled by
    object_diffs; this walks only scalars."""
    out: List[Dict] = []
    if old is None and new is None:
        return out
    sample = new if new is not None else old
    for f in dataclasses.fields(sample):
        if f.name in _IGNORED_FIELDS or f.name.startswith("_"):
            continue
        ov = getattr(old, f.name, None) if old is not None else None
        nv = getattr(new, f.name, None) if new is not None else None
        if not (_scalar(ov) and _scalar(nv)):
            continue
        if ov == nv:
            continue
        if old is None:
            typ = DIFF_ADDED
        elif new is None:
            typ = DIFF_DELETED
        else:
            typ = DIFF_EDITED
        out.append({
            "Type": typ,
            "Name": prefix + _wire(f.name),
            "Old": _fmt(ov),
            "New": _fmt(nv),
        })
    return out


def object_diff(old: Any, new: Any, name: str) -> Optional[Dict]:
    """Nested object diff (diff.go ObjectDiff): recursive over dataclass
    fields; returns None when identical."""
    if old is None and new is None:
        return None
    fields = field_diffs(old, new)
    objects: List[Dict] = []
    sample = new if new is not None else old
    if dataclasses.is_dataclass(sample):
        for f in dataclasses.fields(sample):
            if f.name in _IGNORED_FIELDS or f.name.startswith("_"):
                continue
            ov = getattr(old, f.name, None) if old is not None else None
            nv = getattr(new, f.name, None) if new is not None else None
            if dataclasses.is_dataclass(ov) or dataclasses.is_dataclass(nv):
                sub = object_diff(ov, nv, _wire(f.name))
                if sub is not None:
                    objects.append(sub)
            elif isinstance(ov, dict) or isinstance(nv, dict):
                sub_fields = _map_diffs(ov or {}, nv or {})
                if sub_fields:
                    objects.append({
                        "Type": DIFF_EDITED, "Name": _wire(f.name),
                        "Fields": sub_fields, "Objects": [],
                    })
    if not fields and not objects:
        return None
    if old is None:
        typ = DIFF_ADDED
    elif new is None:
        typ = DIFF_DELETED
    else:
        typ = DIFF_EDITED
    return {"Type": typ, "Name": name, "Fields": fields, "Objects": objects}


def _map_diffs(old: Dict, new: Dict) -> List[Dict]:
    out = []
    for k in sorted(set(old) | set(new)):
        ov, nv = old.get(k), new.get(k)
        if ov == nv or not (_scalar(ov) and _scalar(nv)):
            continue
        typ = DIFF_ADDED if k not in old else DIFF_DELETED if k not in new else DIFF_EDITED
        out.append({"Type": typ, "Name": str(k), "Old": _fmt(ov), "New": _fmt(nv)})
    return out


def task_diff(old, new, name: str) -> Optional[Dict]:
    d = object_diff(old, new, name)
    if d is None:
        return None
    d["Annotations"] = []
    return d


def task_group_diff(old, new, name: str) -> Optional[Dict]:
    """Per-task-group diff with nested per-task diffs (diff.go
    TaskGroupDiff)."""
    if old is None and new is None:
        return None
    fields = field_diffs(old, new)
    old_tasks = {t.name: t for t in (old.tasks if old is not None else [])}
    new_tasks = {t.name: t for t in (new.tasks if new is not None else [])}
    tasks = []
    for tname in sorted(set(old_tasks) | set(new_tasks)):
        td = task_diff(old_tasks.get(tname), new_tasks.get(tname), tname)
        if td is not None:
            tasks.append(td)
    objects = []
    for fname in ("update", "migrate", "reschedule_policy", "restart_policy",
                  "ephemeral_disk", "scaling"):
        ov = getattr(old, fname, None) if old is not None else None
        nv = getattr(new, fname, None) if new is not None else None
        sub = object_diff(ov, nv, _wire(fname))
        if sub is not None:
            objects.append(sub)
    if not fields and not tasks and not objects:
        return None
    typ = DIFF_ADDED if old is None else DIFF_DELETED if new is None else DIFF_EDITED
    return {
        "Type": typ, "Name": name, "Fields": fields, "Objects": objects,
        "Tasks": tasks, "Updates": {},
    }


def job_diff(old, new) -> Dict:
    """Top-level job diff (diff.go Job.Diff)."""
    if old is None and new is None:
        return {"Type": DIFF_NONE, "ID": "", "Fields": [], "Objects": [],
                "TaskGroups": []}
    fields = field_diffs(old, new)
    old_tgs = {tg.name: tg for tg in (old.task_groups if old is not None else [])}
    new_tgs = {tg.name: tg for tg in (new.task_groups if new is not None else [])}
    tgs = []
    for name in sorted(set(old_tgs) | set(new_tgs)):
        d = task_group_diff(old_tgs.get(name), new_tgs.get(name), name)
        if d is not None:
            tgs.append(d)
    objects = []
    for fname in ("periodic", "parameterized", "update"):
        ov = getattr(old, fname, None) if old is not None else None
        nv = getattr(new, fname, None) if new is not None else None
        sub = object_diff(ov, nv, _wire(fname))
        if sub is not None:
            objects.append(sub)
    if old is None:
        typ = DIFF_ADDED
    elif new is None:
        typ = DIFF_DELETED
    elif not fields and not tgs and not objects:
        typ = DIFF_NONE
    else:
        typ = DIFF_EDITED
    job_id = new.id if new is not None else old.id
    return {"Type": typ, "ID": job_id, "Fields": fields, "Objects": objects,
            "TaskGroups": tgs}
