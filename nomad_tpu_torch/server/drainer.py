"""Node drainer: migrate allocs off draining nodes.

Reference behavior: nomad/drainer/ (~2.5k LoC) -- the leader watches
draining nodes and their allocs, batches
``Allocation.DesiredTransition = migrate`` writes through Raft (which
also creates evals so the scheduler places replacements), respects the
drain deadline (force-stop whatever remains), leaves system jobs for
last (``ignore_system_jobs``), and marks the node done when its last
migratable alloc is gone.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from nomad_tpu_torch.server import fsm as fsm_msgs
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import DesiredTransition
from nomad_tpu_torch.structs.eval_plan import Evaluation

LOG = logging.getLogger(__name__)


# DrainStrategy lives with the node structs (wire shape); re-exported
# here for existing importers
from nomad_tpu_torch.structs.node import DrainStrategy  # noqa: E402,F401


class NodeDrainer:
    def __init__(self, server, poll_interval: float = 0.2) -> None:
        self.server = server
        self.poll_interval = poll_interval
        self._enabled = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        #: nodes-table index at which "no node is draining" was last
        #: proven; -1 = unproven (see _tick)
        self._no_drain_idx = -1

    def set_enabled(self, enabled: bool) -> None:
        with self._lock:
            prev, self._enabled = self._enabled, enabled
        if enabled and not prev:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="node-drainer"
            )
            self._thread.start()

    def _run(self) -> None:
        from nomad_tpu_torch.telemetry.trace import tracer

        index = 0
        while self._enabled:
            index = self.server.state.block_until(
                ["nodes", "allocs"], index, timeout=self.poll_interval
            )
            try:
                with tracer.span("bg.drainer"):
                    self._tick()
            except Exception as e:              # noqa: BLE001
                LOG.warning("drainer: %s", e)

    def _tick(self) -> None:
        # every plan commit wakes this loop (the allocs watch drives
        # migrating-alloc progress); with no node draining, building a
        # snapshot per commit is pure overhead. The no-drain proof is
        # cached against the nodes table index: alloc commits then
        # return here without scanning, and only a node write re-checks.
        state = self.server.state
        nodes_idx = state.table_index(["nodes"])
        if nodes_idx == self._no_drain_idx:
            return
        if not state.has_draining_nodes():
            self._no_drain_idx = nodes_idx
            return
        self._no_drain_idx = -1
        snap = state.snapshot()
        for node in snap.nodes():
            if not node.drain:
                continue
            strategy = node.drain_strategy or DrainStrategy()
            self._drain_node(snap, node, strategy)

    def _drain_node(self, snap, node, strategy: DrainStrategy) -> None:
        allocs = [
            a for a in snap.allocs_by_node(node.id)
            if not a.terminal_status() and not a.client_terminal_status()
        ]
        system, service = [], []
        for a in allocs:
            job = a.job or snap.job_by_id(a.namespace, a.job_id)
            if job is not None and job.type in (
                consts.JOB_TYPE_SYSTEM, consts.JOB_TYPE_SYSBATCH,
            ):
                system.append(a)
            else:
                service.append(a)

        force = strategy.deadline_passed()
        # service/batch allocs migrate first; system allocs only when
        # nothing else is left (drainer/drain_heap + watch_jobs)
        to_migrate: List = []
        for a in service:
            if a.desired_transition is None or not a.desired_transition.should_migrate():
                to_migrate.append(a)
        if not service and not strategy.ignore_system_jobs:
            for a in system:
                if a.desired_transition is None or not a.desired_transition.should_migrate():
                    to_migrate.append(a)

        if to_migrate:
            transitions: Dict[str, DesiredTransition] = {}
            evals: List[Evaluation] = []
            seen_jobs = set()
            for a in to_migrate:
                transitions[a.id] = DesiredTransition(
                    migrate=True, force_reschedule=force
                )
                key = (a.namespace, a.job_id)
                if key in seen_jobs:
                    continue
                seen_jobs.add(key)
                job = a.job or snap.job_by_id(a.namespace, a.job_id)
                evals.append(
                    Evaluation(
                        namespace=a.namespace,
                        priority=job.priority if job else 50,
                        type=job.type if job else consts.JOB_TYPE_SERVICE,
                        triggered_by=consts.EVAL_TRIGGER_NODE_DRAIN,
                        job_id=a.job_id,
                        node_id=node.id,
                        status=consts.EVAL_STATUS_PENDING,
                    )
                )
            LOG.info("drainer: migrating %d allocs off %s", len(transitions),
                     node.id[:8])
            self.server.raft_apply(
                fsm_msgs.ALLOC_UPDATE_DESIRED_TRANSITION,
                {"allocs": transitions, "evals": evals},
            )
            return

        if not service and (strategy.ignore_system_jobs or not system):
            # drain complete: clear the drain flag but keep the node
            # ineligible until the operator re-enables it
            LOG.info("drainer: node %s drain complete", node.id[:8])
            self.server.raft_apply(
                fsm_msgs.NODE_UPDATE_DRAIN,
                {"node_id": node.id, "drain": False, "strategy": None,
                 "mark_eligible": False},
            )
