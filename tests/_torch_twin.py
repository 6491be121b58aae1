"""Two harnesses in lockstep: the JAX package's and the port's.

Every piece of state is made once with the reference package (its
``mock`` and ``structs``) and carried across with
``convert.structs_from_reference`` (one memo for the whole run, so an
object reached twice stays one object on the port's side). Every write
goes to both stores in the same order, so ``latest_index()`` agrees
before each eval, and with it the shuffle and port seeds
(``crc32(f"{eval.id}:{latest_index}")``). Allocation ids are random in
each package, so allocations are matched by name.
"""

import numpy as np

from nomad_tpu import mock
from nomad_tpu.scheduler.testing import Harness as RefHarness
from nomad_tpu.structs import consts
from nomad_tpu_torch.convert import structs_from_reference
from nomad_tpu_torch.scheduler.testing import Harness as PortHarness

SCORE_ATOL = 1e-5

#: AllocMetric counters compared exactly
METRIC_COUNTERS = (
    "nodes_evaluated", "nodes_filtered", "nodes_in_pool",
    "nodes_available", "class_filtered", "constraint_filtered",
    "nodes_exhausted", "class_exhausted", "dimension_exhausted",
    "quota_exhausted", "coalesced_failures",
)


class Twin:
    def __init__(self):
        self.ref = RefHarness()
        self.port = PortHarness(device="cpu")
        self.memo = {}
        self._seen = {"plans": 0, "evals": 0, "create_evals": 0,
                      "reblock_evals": 0}

    def conv(self, obj):
        return structs_from_reference(obj, self.memo)

    @property
    def sides(self):
        return (self.ref, self.port)

    # -- writes, mirrored ------------------------------------------------

    def upsert_node(self, node):
        port = self.conv(node)
        self.ref.state.upsert_node(node)
        self.port.state.upsert_node(port)

    def add_nodes(self, n, **kw):
        nodes = [mock.node(**kw) for _ in range(n)]
        for nd in nodes:
            self.upsert_node(nd)
        return nodes

    def upsert_job(self, job):
        port = self.conv(job)
        self.ref.state.upsert_job(job)
        self.port.state.upsert_job(port)

    def upsert_allocs(self, allocs):
        port = self.conv(allocs)
        self.ref.state.upsert_allocs(allocs)
        self.port.state.upsert_allocs(port)

    def update_node_drain(self, node_id, drain):
        for h in self.sides:
            h.state.update_node_drain(node_id, drain)

    def update_node_status(self, node_id, status):
        for h in self.sides:
            h.state.update_node_status(node_id, status)

    def set_reject_plan(self, value):
        for h in self.sides:
            h.reject_plan = value

    def update_allocs(self, job, pick, mutate):
        """``pick`` chooses from the job's allocs sorted by name (the same
        names on both sides); each chosen alloc's copy is changed by
        ``mutate`` and upserted. Returns the number upserted."""
        counts = []
        for h in self.sides:
            snap = h.state.snapshot()
            allocs = sorted(snap.allocs_by_job(job.namespace, job.id),
                            key=lambda a: (a.name, a.create_index))
            updates = []
            for a in pick(allocs):
                b = a.copy_skip_job()
                mutate(b)
                updates.append(b)
            h.state.upsert_allocs(updates)
            counts.append([(b.name, b.node_id) for b in updates])
        assert counts[0] == counts[1]
        return len(counts[0])

    # -- one eval on both sides, then the comparison ---------------------

    def run_eval(self, job, trigger=consts.EVAL_TRIGGER_JOB_REGISTER,
                 sched=None):
        ev = mock.eval(job_id=job.id, namespace=job.namespace, type=job.type,
                       triggered_by=trigger, priority=job.priority)
        port_ev = self.conv(ev)
        self.ref.state.upsert_evals([ev])
        self.port.state.upsert_evals([port_ev])
        assert (self.ref.state.latest_index()
                == self.port.state.latest_index())
        self.ref.process(sched or job.type, ev)
        self.port.process(sched or job.type, port_ev)
        self.compare()
        return ev

    def compare(self):
        for attr, fn in (("plans", compare_plan), ("evals", compare_eval),
                         ("create_evals", compare_eval),
                         ("reblock_evals", compare_eval)):
            got_r = getattr(self.ref, attr)
            got_p = getattr(self.port, attr)
            assert len(got_r) == len(got_p), (attr, len(got_r), len(got_p))
            for r, p in zip(got_r[self._seen[attr]:],
                            got_p[self._seen[attr]:]):
                fn(r, p)
            self._seen[attr] = len(got_r)
        assert (self.ref.state.latest_index()
                == self.port.state.latest_index())


def _by_name(node_map):
    out = {}
    for node_id, allocs in node_map.items():
        for a in allocs:
            assert a.node_id == node_id
            out.setdefault(a.name, []).append(a)
    return out


def compare_metrics(r, p, scores=True):
    assert (r is None) == (p is None)
    if r is None:
        return
    for name in METRIC_COUNTERS:
        assert getattr(r, name) == getattr(p, name), name
    if not scores:
        return
    assert len(r.score_meta) == len(p.score_meta), (r.score_meta,
                                                    p.score_meta)
    for (rn, rs, rf), (pn, ps, pf) in zip(r.score_meta, p.score_meta):
        assert rn == pn
        assert rs.keys() == ps.keys()
        for k in rs:
            np.testing.assert_allclose(ps[k], rs[k], rtol=0, atol=SCORE_ATOL)
        np.testing.assert_allclose(pf, rf, rtol=0, atol=SCORE_ATOL)


def _named_ids(plan, text):
    """``text`` with the id of each alloc the plan places read as its
    name: a preempted alloc's description names the new alloc's id, which
    is random on each side."""
    for allocs in plan.node_allocation.values():
        for a in allocs:
            text = text.replace(a.id, a.name)
    return text


def compare_plan(r, p):
    for field in ("node_allocation", "node_update", "node_preemptions"):
        rm, pm = _by_name(getattr(r, field)), _by_name(getattr(p, field))
        assert rm.keys() == pm.keys(), field
        for name in rm:
            ra, pa = rm[name], pm[name]
            assert ([a.node_id for a in ra] == [a.node_id for a in pa]), \
                (field, name)
            for a, b in zip(ra, pa):
                for attr in ("desired_status", "client_status",
                             "job_version", "task_group"):
                    assert getattr(a, attr) == getattr(b, attr), (
                        field, name, attr)
                assert (_named_ids(r, a.desired_description)
                        == _named_ids(p, b.desired_description)), (
                    field, name)
                if field == "node_allocation":
                    compare_metrics(a.metrics, b.metrics)
                    assert ((a.previous_allocation == "")
                            == (b.previous_allocation == ""))
    assert (r.deployment is None) == (p.deployment is None)
    assert len(r.deployment_updates) == len(p.deployment_updates)


def compare_eval(r, p):
    for attr in ("status", "status_description", "triggered_by", "type",
                 "job_id", "queued_allocations", "class_eligibility",
                 "escaped_computed_class", "quota_limit_reached"):
        assert getattr(r, attr) == getattr(p, attr), attr
    assert (r.wait_until_s > 0) == (p.wait_until_s > 0)
    assert (r.blocked_eval == "") == (p.blocked_eval == "")
    assert r.failed_tg_allocs.keys() == p.failed_tg_allocs.keys()
    for tg in r.failed_tg_allocs:
        compare_metrics(r.failed_tg_allocs[tg], p.failed_tg_allocs[tg])
