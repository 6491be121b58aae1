"""FSM: the replicated state machine applied at the Raft boundary.

Reference behavior: nomad/fsm.go -- ``nomadFSM.Apply`` dispatches ~45
message types onto StateStore mutations (fsm.go:194-280) and notifies
the leader-only subsystems (eval broker, blocked evals) which are
no-ops on followers because they are disabled there. Every state
mutation in the server flows through ``FSM.apply`` so that task-2's
replication layer can ship the same (msg_type, payload) entries through
a real log.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.eval_plan import Evaluation

# Message types (fsm.go MessageType constants)
NODE_REGISTER = "NodeRegisterRequestType"
NODE_DEREGISTER = "NodeDeregisterRequestType"
NODE_UPDATE_STATUS = "NodeUpdateStatusRequestType"
NODE_UPDATE_DRAIN = "NodeUpdateDrainRequestType"
NODE_UPDATE_ELIGIBILITY = "NodeUpdateEligibilityRequestType"
JOB_REGISTER = "JobRegisterRequestType"
JOB_DEREGISTER = "JobDeregisterRequestType"
EVAL_UPDATE = "EvalUpdateRequestType"
EVAL_DELETE = "EvalDeleteRequestType"
ALLOC_CLIENT_UPDATE = "AllocClientUpdateRequestType"
ALLOC_UPDATE_DESIRED_TRANSITION = "AllocUpdateDesiredTransitionRequestType"
ALLOC_STOP = "AllocStopRequestType"
APPLY_PLAN_RESULTS = "ApplyPlanResultsRequestType"
DEPLOYMENT_STATUS_UPDATE = "DeploymentStatusUpdateRequestType"
DEPLOYMENT_ALLOC_HEALTH = "DeploymentAllocHealthRequestType"
DEPLOYMENT_PROMOTE = "DeploymentPromoteRequestType"
DEPLOYMENT_DELETE = "DeploymentDeleteRequestType"
ALLOC_DELETE = "AllocDeleteRequestType"
SCHEDULER_CONFIG = "SchedulerConfigRequestType"
JOB_STABILITY = "JobStabilityRequestType"
SCALING_EVENT = "ScalingEventRegisterRequestType"
NAMESPACE_UPSERT = "NamespaceUpsertRequestType"
NAMESPACE_DELETE = "NamespaceDeleteRequestType"
ACL_POLICY_UPSERT = "ACLPolicyUpsertRequestType"
ACL_POLICY_DELETE = "ACLPolicyDeleteRequestType"
ACL_TOKEN_UPSERT = "ACLTokenUpsertRequestType"
ACL_TOKEN_DELETE = "ACLTokenDeleteRequestType"
CSI_VOLUME_REGISTER = "CSIVolumeRegisterRequestType"
CSI_VOLUME_DEREGISTER = "CSIVolumeDeregisterRequestType"
CSI_VOLUME_CLAIM = "CSIVolumeClaimRequestType"
CSI_VOLUME_CLAIM_BATCH = "CSIVolumeClaimBatchRequestType"
SERVICE_REG_UPSERT = "ServiceRegistrationUpsertRequestType"
SERVICE_REG_DELETE_BY_ID = "ServiceRegistrationDeleteByIDRequestType"
SERVICE_REG_DELETE_BY_ALLOC = "ServiceRegistrationDeleteByAllocRequestType"
SERVICE_REG_DELETE_BY_NODE = "ServiceRegistrationDeleteByNodeIDRequestType"
ONE_TIME_TOKEN_UPSERT = "OneTimeTokenUpsertRequestType"
ONE_TIME_TOKEN_DELETE = "OneTimeTokenDeleteRequestType"
ONE_TIME_TOKEN_EXPIRE = "OneTimeTokenExpireRequestType"
PERIODIC_LAUNCH_UPSERT = "PeriodicLaunchRequestType"
PERIODIC_LAUNCH_DELETE = "PeriodicLaunchDeleteRequestType"
AUTOPILOT_CONFIG = "AutopilotRequestType"
REGION_UPSERT = "RegionUpsertRequestType"


class NomadFSM:
    """Applies committed log entries to the state store."""

    def __init__(self, state_store, eval_broker=None, blocked_evals=None,
                 event_broker=None) -> None:
        self.state = state_store
        # leader-only subsystems; disabled instances ignore calls
        self.eval_broker = eval_broker
        self.blocked_evals = blocked_evals
        # change feed (nomad/stream; events published as applies commit)
        self.event_broker = event_broker
        self._lock = threading.Lock()

    def apply(self, msg_type: str, req: Dict) -> int:
        import time

        from nomad_tpu_torch.telemetry.trace import tracer
        from nomad_tpu_torch.utils.faultpoints import fault

        # the FSM dispatch seam (chaos plane): single-server error
        # injection fails the whole raft_apply before any mutation;
        # latency injection stalls the apply loop (replicated-safe)
        fault("fsm.apply.pre")
        handler = self._DISPATCH.get(msg_type)
        if handler is None:
            raise ValueError(f"unknown FSM message type {msg_type}")
        with tracer.span("fsm.apply"):
            with self._lock:
                index = handler(self, req)
            # stamp at apply-commit time: the event-stream delivery-lag
            # histogram (op="stream_deliver") measures from HERE to the
            # consumer hand-off, so publish/ring/drain overhead is all
            # inside the measured window
            self._publish_events(msg_type, req, index,
                                 stamp=time.monotonic())
        return index

    def apply_batch(self, entries: List[Tuple[str, Dict]]) -> List:
        """Apply a committed run of entries as ONE store batch: one
        FSM-lock span, one root swap (``StateStore.batch_txn``), one
        event-broker publish stamp. Returns one ``(index, error)`` per
        entry, in order — an entry that raises poisons only itself
        (its slot carries the exception, its writes fold away with its
        aborted inner txn) and the rest of the batch still commits,
        matching the per-entry apply's containment.

        Events are collected per entry (each carries its own commit
        index) but published once, AFTER the batch root is visible —
        so a consumer woken by the stream can always read the state
        that produced it, and deployment lookups resolve against the
        committed batch."""
        import time

        from nomad_tpu_torch.telemetry.trace import tracer
        from nomad_tpu_torch.utils.faultpoints import fault

        results: List = []
        pending_events: List[Tuple[str, Dict, int]] = []
        with tracer.span("fsm.apply"):
            with self._lock:
                with self.state.batch_txn():
                    for msg_type, req in entries:
                        try:
                            fault("fsm.apply.pre")
                            handler = self._DISPATCH.get(msg_type)
                            if handler is None:
                                raise ValueError(
                                    f"unknown FSM message type {msg_type}")
                            index = handler(self, req)
                        except Exception as exc:  # noqa: BLE001
                            results.append((None, exc))
                        else:
                            results.append((index, None))
                            pending_events.append((msg_type, req, index))
            # one stamp for the whole batch: the delivery-lag window
            # starts when the batch commits, same as the per-entry path
            stamp = time.monotonic()
            events = []
            for msg_type, req, index in pending_events:
                self._collect_events(events, msg_type, req, index)
            if events and self.event_broker is not None:
                self.event_broker.publish(events, stamp=stamp)
        return results

    def _publish_events(self, msg_type: str, req: Dict, index: int,
                        stamp: float = 0.0) -> None:
        if self.event_broker is None:
            return
        events: List = []
        self._collect_events(events, msg_type, req, index)
        if events:
            self.event_broker.publish(events, stamp=stamp or None)

    def _collect_events(self, events: List, msg_type: str, req: Dict,
                        index: int) -> None:
        from nomad_tpu_torch.server import stream

        def ev(topic, etype, key, payload=None, ns=""):
            events.append(stream.Event(
                topic=topic, type=etype, key=key, index=index,
                payload=payload, namespace=ns,
            ))

        if msg_type == NODE_REGISTER:
            ev(stream.TOPIC_NODE, "NodeRegistration", req["node"].id, req["node"])
        elif msg_type == NODE_DEREGISTER:
            ev(stream.TOPIC_NODE, "NodeDeregistration", req["node_id"])
        elif msg_type in (NODE_UPDATE_STATUS, NODE_UPDATE_DRAIN,
                          NODE_UPDATE_ELIGIBILITY):
            ev(stream.TOPIC_NODE, "NodeUpdate", req["node_id"])
        elif msg_type == JOB_REGISTER:
            job = req["job"]
            ev(stream.TOPIC_JOB, "JobRegistered", job.id, job, job.namespace)
        elif msg_type == JOB_DEREGISTER:
            ev(stream.TOPIC_JOB, "JobDeregistered", req["job_id"],
               None, req["namespace"])
        elif msg_type == EVAL_UPDATE:
            for e in req.get("evals", []):
                ev(stream.TOPIC_EVAL, "EvaluationUpdated", e.id, e, e.namespace)
        elif msg_type == ALLOC_CLIENT_UPDATE:
            for a in req.get("allocs", []):
                ev(stream.TOPIC_ALLOC, "AllocationUpdated", a.id, a, a.namespace)
        elif msg_type == APPLY_PLAN_RESULTS:
            for p in req.get("plans") or [req]:
                for allocs in p.get("node_allocation", {}).values():
                    for a in allocs:
                        ev(stream.TOPIC_ALLOC, "PlanResult", a.id, a,
                           a.namespace)
        elif msg_type in (DEPLOYMENT_STATUS_UPDATE, DEPLOYMENT_ALLOC_HEALTH,
                          DEPLOYMENT_PROMOTE):
            d = self.state.deployment_by_id(req["deployment_id"])
            # deployment already gone (racing GC): skip rather than
            # publish a namespace-less event the ACL filter would
            # misroute to default-scoped subscribers
            if d is not None:
                ev(stream.TOPIC_DEPLOYMENT, "DeploymentUpdate",
                   req["deployment_id"], d, d.namespace or "")

    # --- node (fsm.go applyUpsertNode etc.) -----------------------------

    def _apply_node_register(self, req: Dict) -> int:
        return self.state.upsert_node(req["node"])

    def _apply_node_deregister(self, req: Dict) -> int:
        return self.state.delete_node(req["node_id"])

    def _apply_node_update_status(self, req: Dict) -> int:
        return self.state.update_node_status(req["node_id"], req["status"])

    def _apply_node_update_drain(self, req: Dict) -> int:
        return self.state.update_node_drain(
            req["node_id"], req["drain"], req.get("strategy"),
            req.get("mark_eligible", True),
        )

    def _apply_node_update_eligibility(self, req: Dict) -> int:
        return self.state.update_node_eligibility(
            req["node_id"], req["eligibility"]
        )

    # --- job ------------------------------------------------------------

    # set by the server; leader-only (no-op while disabled)
    periodic_dispatcher = None

    def _apply_job_register(self, req: Dict) -> int:
        index = self.state.upsert_job(req["job"])
        for ev in req.get("evals", []):
            self._upsert_eval(ev, index)
        if self.periodic_dispatcher is not None:
            # fsm.go applyUpsertJob -> periodicDispatcher.Add
            self.periodic_dispatcher.add(req["job"])
        return index

    def _apply_job_deregister(self, req: Dict) -> int:
        ns, job_id = req["namespace"], req["job_id"]
        if req.get("purge"):
            index = self.state.delete_job(ns, job_id)
        else:
            job = self.state.job_by_id_direct(ns, job_id)
            if job is None:
                index = self.state.latest_index()
            else:
                stopped = job.copy()
                stopped.stop = True
                index = self.state.upsert_job(stopped)
        for ev in req.get("evals", []):
            self._upsert_eval(ev, index)
        if self.blocked_evals is not None:
            self.blocked_evals.untrack(ns, job_id)
        if self.periodic_dispatcher is not None:
            self.periodic_dispatcher.remove(ns, job_id)
        return index

    # --- evals (fsm.go applyUpdateEval -> upsertEvals) ------------------

    def _apply_eval_update(self, req: Dict) -> int:
        evals: List[Evaluation] = req["evals"]
        index = self.state.upsert_evals(evals)
        for ev in evals:
            self._eval_notify(ev)
        return index

    def _upsert_eval(self, ev: Evaluation, index: int) -> None:
        self.state.upsert_evals([ev])
        self._eval_notify(ev)

    def _eval_notify(self, ev: Evaluation) -> None:
        """fsm.go upsertEvals: enqueue pending evals on the leader's
        broker, track blocked ones, untrack on terminal."""
        if ev.should_enqueue() and self.eval_broker is not None:
            self.eval_broker.enqueue(ev)
        elif ev.should_block() and self.blocked_evals is not None:
            self.blocked_evals.block(ev)
        elif (
            ev.status == consts.EVAL_STATUS_COMPLETE
            and not ev.failed_tg_allocs
            and self.blocked_evals is not None
        ):
            # fully-successful eval: drop any stale blocked entry for the
            # job (fsm.go upsertEvals untrack-on-complete; the guard on
            # failed_tg_allocs keeps the blocked eval the same batch
            # created)
            self.blocked_evals.untrack(ev.namespace, ev.job_id)

    def _apply_eval_delete(self, req: Dict) -> int:
        return self.state.delete_evals(req["eval_ids"])

    # --- allocs ---------------------------------------------------------

    def _apply_alloc_client_update(self, req: Dict) -> int:
        allocs = req["allocs"]
        index = self.state.update_allocs_from_client(allocs)
        for ev in req.get("evals", []):
            self._upsert_eval(ev, index)
        # terminal client status frees capacity: unblock by node class
        # (fsm.go applyAllocClientUpdate -> blockedEvals.Unblock).
        # Single-row reads off the current MVCC root (under the seed
        # store a full snapshot per heartbeat batch forced whole-table
        # COW copies on the next write; now both are free).
        if self.blocked_evals is not None:
            for a in allocs:
                if a.client_terminal_status():
                    node = self.state.node_by_id_direct(a.node_id)
                    if node is not None:
                        self.blocked_evals.unblock(node.computed_class, index)
        return index

    def _apply_alloc_update_desired_transition(self, req: Dict) -> int:
        index = self.state.update_allocs_desired_transition(
            req["allocs"], req.get("evals", [])
        )
        for ev in req.get("evals", []):
            self._eval_notify(ev)
        return index

    def _apply_alloc_stop(self, req: Dict) -> int:
        index = self.state.stop_alloc(req["alloc_id"], req.get("evals", []))
        for ev in req.get("evals", []):
            self._eval_notify(ev)
        return index

    # --- plan results ---------------------------------------------------

    def _apply_plan_results(self, req: Dict) -> int:
        # batched form ({"plans": [...]}, one raft entry per applier
        # pass); a bare single-plan request (older raft log entries)
        # is normalized into a batch of one
        plans = req.get("plans")
        if plans is None:
            plans = [req]
        index = self.state.upsert_plan_results_batch(
            req.get("alloc_index", 0), plans)
        # preempted/stopped allocs free capacity
        freed_nodes = {
            nid
            for p in plans
            for nid in list(p["node_update"]) + list(p["node_preemptions"])
        }
        if self.blocked_evals is not None and freed_nodes:
            # lock-free single-row reads: one batched plan apply is
            # the FSM's hottest entry
            classes = set()
            for nid in freed_nodes:
                node = self.state.node_by_id_direct(nid)
                if node is not None:
                    classes.add(node.computed_class)
            for cls in classes:
                self.blocked_evals.unblock(cls, index)
        return index

    # --- deployment / config --------------------------------------------

    def _apply_deployment_alloc_health(self, req: Dict) -> int:
        index = self.state.update_deployment_alloc_health(
            req["deployment_id"],
            req.get("healthy_ids", []),
            req.get("unhealthy_ids", []),
            req.get("deployment_update"),
            req.get("evals", []),
        )
        for ev in req.get("evals", []):
            self._eval_notify(ev)
        return index

    def _apply_deployment_promote(self, req: Dict) -> int:
        index = self.state.update_deployment_promotion(
            req["deployment_id"], req.get("groups"), req.get("evals", []),
        )
        for ev in req.get("evals", []):
            self._eval_notify(ev)
        return index

    def _apply_deployment_delete(self, req: Dict) -> int:
        return self.state.delete_deployments(req["deployment_ids"])

    def _apply_alloc_delete(self, req: Dict) -> int:
        return self.state.delete_allocs(req["alloc_ids"])

    def _apply_deployment_status_update(self, req: Dict) -> int:
        index = self.state.update_deployment_status(
            req["deployment_id"], req["status"], req.get("description", "")
        )
        for ev in req.get("evals", []):
            self._upsert_eval(ev, index)
        return index

    def _apply_scheduler_config(self, req: Dict) -> int:
        return self.state.set_scheduler_config(req["config"])

    # --- aux tables (stability / scaling / namespaces / ACL) ------------

    def _apply_job_stability(self, req: Dict) -> int:
        return self.state.set_job_stability(
            req["namespace"], req["job_id"], req["version"], req["stable"]
        )

    def _apply_scaling_event(self, req: Dict) -> int:
        return self.state.record_scaling_event(
            req["namespace"], req["job_id"], req["group"], req["event"]
        )

    def _apply_namespace_upsert(self, req: Dict) -> int:
        idx = 0
        for ns in req["namespaces"]:
            idx = self.state.upsert_namespace(ns)
        return idx

    def _apply_namespace_delete(self, req: Dict) -> int:
        idx = 0
        for name in req["names"]:
            idx = self.state.delete_namespace(name)
        return idx

    def _apply_acl_policy_upsert(self, req: Dict) -> int:
        idx = 0
        for p in req["policies"]:
            idx = self.state.upsert_acl_policy(p)
        return idx

    def _apply_acl_policy_delete(self, req: Dict) -> int:
        idx = 0
        for name in req["names"]:
            idx = self.state.delete_acl_policy(name)
        return idx

    def _apply_acl_token_upsert(self, req: Dict) -> int:
        idx = 0
        for t in req["tokens"]:
            idx = self.state.upsert_acl_token(t)
        return idx

    def _apply_acl_token_delete(self, req: Dict) -> int:
        idx = 0
        for aid in req["accessor_ids"]:
            idx = self.state.delete_acl_token(aid)
        return idx

    def _apply_csi_volume_register(self, req: Dict) -> int:
        return self.state.upsert_csi_volumes(req["volumes"])

    def _apply_csi_volume_deregister(self, req: Dict) -> int:
        return self.state.csi_volume_deregister(
            req["namespace"], req["volume_id"], req.get("force", False)
        )

    def _apply_csi_volume_claim(self, req: Dict) -> int:
        return self.state.csi_volume_claim(
            req["namespace"], req["volume_id"], req["claim"]
        )

    def _apply_csi_volume_claim_batch(self, req: Dict) -> int:
        """volumewatcher batched claim updates (fsm.go
        applyCSIVolumeBatchClaim)."""
        idx = 0
        for c in req["claims"]:
            idx = self.state.csi_volume_claim(
                c["namespace"], c["volume_id"], c["claim"]
            )
        return idx

    def _apply_service_reg_upsert(self, req: Dict) -> int:
        return self.state.upsert_service_registrations(req["services"])

    def _apply_service_reg_delete_by_id(self, req: Dict) -> int:
        return self.state.delete_service_registration(req["id"])

    def _apply_service_reg_delete_by_alloc(self, req: Dict) -> int:
        return self.state.delete_service_registrations_by_alloc(
            req["alloc_ids"]
        )

    def _apply_service_reg_delete_by_node(self, req: Dict) -> int:
        return self.state.delete_service_registrations_by_node(req["node_id"])

    def _apply_one_time_token_upsert(self, req: Dict) -> int:
        return self.state.upsert_one_time_token(req["token"])

    def _apply_one_time_token_delete(self, req: Dict) -> int:
        return self.state.delete_one_time_tokens(req["secrets"])

    def _apply_one_time_token_expire(self, req: Dict) -> int:
        expired = self.state.expire_one_time_tokens(req["now"])
        return self.state.delete_one_time_tokens(expired)

    def _apply_periodic_launch_upsert(self, req: Dict) -> int:
        return self.state.upsert_periodic_launch(
            req["namespace"], req["job_id"], req["launch_time"]
        )

    def _apply_periodic_launch_delete(self, req: Dict) -> int:
        return self.state.delete_periodic_launch(
            req["namespace"], req["job_id"]
        )

    def _apply_autopilot_config(self, req: Dict) -> int:
        return self.state.set_autopilot_config(req["config"])

    def _apply_region_upsert(self, req: Dict) -> int:
        return self.state.upsert_region(req["region"], req["http_addr"])

    _DISPATCH = {
        NODE_REGISTER: _apply_node_register,
        NODE_DEREGISTER: _apply_node_deregister,
        NODE_UPDATE_STATUS: _apply_node_update_status,
        NODE_UPDATE_DRAIN: _apply_node_update_drain,
        NODE_UPDATE_ELIGIBILITY: _apply_node_update_eligibility,
        JOB_REGISTER: _apply_job_register,
        JOB_DEREGISTER: _apply_job_deregister,
        EVAL_UPDATE: _apply_eval_update,
        EVAL_DELETE: _apply_eval_delete,
        ALLOC_CLIENT_UPDATE: _apply_alloc_client_update,
        ALLOC_UPDATE_DESIRED_TRANSITION: _apply_alloc_update_desired_transition,
        ALLOC_STOP: _apply_alloc_stop,
        APPLY_PLAN_RESULTS: _apply_plan_results,
        DEPLOYMENT_STATUS_UPDATE: _apply_deployment_status_update,
        DEPLOYMENT_ALLOC_HEALTH: _apply_deployment_alloc_health,
        DEPLOYMENT_PROMOTE: _apply_deployment_promote,
        DEPLOYMENT_DELETE: _apply_deployment_delete,
        ALLOC_DELETE: _apply_alloc_delete,
        SCHEDULER_CONFIG: _apply_scheduler_config,
        JOB_STABILITY: _apply_job_stability,
        SCALING_EVENT: _apply_scaling_event,
        NAMESPACE_UPSERT: _apply_namespace_upsert,
        NAMESPACE_DELETE: _apply_namespace_delete,
        ACL_POLICY_UPSERT: _apply_acl_policy_upsert,
        ACL_POLICY_DELETE: _apply_acl_policy_delete,
        ACL_TOKEN_UPSERT: _apply_acl_token_upsert,
        ACL_TOKEN_DELETE: _apply_acl_token_delete,
        CSI_VOLUME_REGISTER: _apply_csi_volume_register,
        CSI_VOLUME_DEREGISTER: _apply_csi_volume_deregister,
        CSI_VOLUME_CLAIM: _apply_csi_volume_claim,
        CSI_VOLUME_CLAIM_BATCH: _apply_csi_volume_claim_batch,
        SERVICE_REG_UPSERT: _apply_service_reg_upsert,
        SERVICE_REG_DELETE_BY_ID: _apply_service_reg_delete_by_id,
        SERVICE_REG_DELETE_BY_ALLOC: _apply_service_reg_delete_by_alloc,
        SERVICE_REG_DELETE_BY_NODE: _apply_service_reg_delete_by_node,
        ONE_TIME_TOKEN_UPSERT: _apply_one_time_token_upsert,
        ONE_TIME_TOKEN_DELETE: _apply_one_time_token_delete,
        ONE_TIME_TOKEN_EXPIRE: _apply_one_time_token_expire,
        PERIODIC_LAUNCH_UPSERT: _apply_periodic_launch_upsert,
        PERIODIC_LAUNCH_DELETE: _apply_periodic_launch_delete,
        AUTOPILOT_CONFIG: _apply_autopilot_config,
        REGION_UPSERT: _apply_region_upsert,
    }
