"""Placement stacks: the host orchestration around the device kernel.

Reference behavior: scheduler/stack.go GenericStack (:43-187) and
SystemStack (:191-341). One reference ``Select`` call places one alloc;
the TPU stack's ``select_many`` places *all* missing allocs of a task
group in one kernel launch (the lax.scan placement axis), then performs
exact host-side port and device assignment for the chosen nodes
(AssignPorts/AssignNetwork network.go:427,517; AssignDevice
device.go:32). If exact assignment disagrees with the kernel's
count-based planes (rare: overlapping device groups), the node is
masked and the remaining placements re-run -- semantics stay exact,
the kernel stays fast.

Counterpart of ``nomad_tpu/scheduler/stack.py``. The launcher that
``EvalContext.kernel_launch`` names (``ops/kernel.default_kernel_launch``
or ``LaunchCoalescer.launch``) hands back host numpy and ints, read back
from the device in one packed copy; only the top-k planes may stay on
the device, behind lazy holders that the plan's deferred work resolves.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from nomad_tpu_torch.ops.kernel import (
    MAX_PENALTY_NODES,
    NEG_INF,
    KernelOut,
    build_kernel_in,
    infer_features,
    neutral_planes,
    neutral_port_words,
    neutral_step_planes,
    pad_steps,
    pad_steps_live,
)
from nomad_tpu_torch.scheduler.context import EvalContext
from nomad_tpu_torch.scheduler.device import DeviceAllocator, device_planes_for_node
from nomad_tpu_torch.scheduler.feasible import FeasibilityBuilder
from nomad_tpu_torch.scheduler.scaffold import MetricsSkeleton, scaffold_for
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.telemetry.trace import tracer
from nomad_tpu_torch.structs.alloc import AllocMetric
from nomad_tpu_torch.structs.constraints import matches_affinity, resolve_target
from nomad_tpu_torch.structs.network import NetworkIndex, NetworkResource, Port
from nomad_tpu_torch.structs.resources import (
    AllocatedCpuResources,
    AllocatedMemoryResources,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
)
from nomad_tpu_torch.tensors.schema import (
    MAX_DEV_REQS,
    SPREAD_BUCKETS,
    AskTensor,
    ClusterTensors,
    EvalTensors,
    SpreadTensor,
)


import threading as _threading

#: process-wide hot-path observability (surfaced via Server.stats()
#: -> /v1/agent/self): how often exact host-side assignment disagreed
#: with the kernel and forced a masked re-run
_STATS_LOCK = _threading.Lock()
STATS = {"assign_retry_launches": 0}


@dataclass
class SelectRequest:
    """One placement ask (reference SelectOptions + placement name)."""

    name: str = ""
    prev_alloc: Optional[object] = None
    penalty_nodes: Tuple[str, ...] = ()
    preferred_node: str = ""


@dataclass
class SelectedOption:
    """One placement result (reference RankedNode after ranking)."""

    node_id: str
    node: object
    final_score: float
    task_resources: Dict[str, AllocatedTaskResources]
    task_lifecycles: Dict[str, Optional[object]]
    alloc_resources: Optional[AllocatedSharedResources]
    metrics: AllocMetric
    preempted_allocs: List = field(default_factory=list)
    #: lean fast path: the (job, tg)-shared frozen AllocatedResources
    #: skeleton (scheduler/scaffold.py). When set, the alloc builder
    #: rides it BY REFERENCE instead of assembling per-slot structs;
    #: None = the exact assigner built per-slot resources (networks/
    #: devices/cores)
    resources: Optional[object] = None


class XLAGenericStack:
    """The xla-binpack stack (GenericStack on the TPU kernel)."""

    def __init__(self, batch: bool, ctx: EvalContext, cluster: ClusterTensors) -> None:
        self.batch = batch
        self.ctx = ctx
        self.cluster = cluster
        self.job = None
        self._feas = FeasibilityBuilder(cluster, ctx.state, ctx)
        self._affinity_cache: Dict[Tuple[str, str], float] = {}
        # seeded node-order decorrelation (shuffleNodes util.go:464 --
        # seeded by eval id + state index); None = deterministic argmax
        self.shuffle_seed: Optional[int] = None

    # -- job/tg configuration (stack.go SetJob) --------------------------

    def set_job(self, job) -> None:
        self.job = job
        self.ctx.eligibility.set_job(job)
        self._affinity_cache.clear()

    # -- main entry ------------------------------------------------------

    def select_many(
        self, tg, requests: List[SelectRequest]
    ) -> List[Optional[SelectedOption]]:
        """Place len(requests) allocs of task group tg."""
        if not requests:
            return []
        c = self.cluster
        snapshot = self.ctx.state
        k = len(requests)
        # live launches floor the step bucket (ops/kernel.pad_steps_live)
        # so follow-up evals placing a couple of leftover allocs reuse
        # the primary evals' compiled programs instead of forking tiny
        # per-k variants
        k_pad = pad_steps_live(k)

        node_perm = None
        if self.shuffle_seed is not None:
            rng = np.random.default_rng(self.shuffle_seed)
            node_perm = rng.permutation(c.n_pad).astype(np.int32)

        exclude = np.zeros(c.n_pad, bool)
        results: List[Optional[SelectedOption]] = [None] * k
        pending = list(range(k))
        # assigners persist across retry attempts so ports/devices/cores
        # consumed by already-accepted slots stay consumed
        assigners: Dict[int, "_NodeAssigner"] = {}
        # rows of placements accepted in earlier attempts of this call;
        # their resources are re-applied to rebuilt eval tensors
        accepted_rows: List[int] = []

        for _attempt in range(3):
            ev = self._build_eval_tensors(tg, exclude)
            for row in accepted_rows:
                self._apply_accepted(ev, row)
            if any(requests[ri].penalty_nodes or requests[ri].preferred_node
                   for ri in pending):
                step_penalty = np.full(
                    (k_pad, MAX_PENALTY_NODES), -1, np.int32)
                step_preferred = np.full(k_pad, -1, np.int32)
                for slot, ri in enumerate(pending):
                    req = requests[ri]
                    for j, nid in enumerate(
                            req.penalty_nodes[:MAX_PENALTY_NODES]):
                        row = c.index.get(nid, -1)
                        step_penalty[slot, j] = row
                    if req.preferred_node:
                        step_preferred[slot] = c.index.get(
                            req.preferred_node, -1)
            else:
                # the common ask has no penalties/preferences: ship the
                # frozen singletons so wave members share them by
                # identity (one upload per wave, not per member)
                step_penalty, step_preferred = neutral_step_planes(k_pad)

            kin = build_kernel_in(c, ev, len(pending), step_penalty,
                                  step_preferred, node_perm=node_perm)
            features = infer_features(
                ev,
                any_penalty=any(requests[ri].penalty_nodes for ri in pending),
                any_preferred=any(requests[ri].preferred_node for ri in pending),
                with_shuffle=node_perm is not None,
            )
            out = self.ctx.kernel_launch(kin, k_pad, features)
            # selective host fetch: the planes the walk reads NOW come
            # to host (tiny [K] vectors — one transfer each); the
            # top-k score planes stay as the launcher handed them
            # (device arrays / lazy wave slices) until the plan
            # window's deferred score_meta drain resolves them
            out = KernelOut(*[
                x if f in ("topk_idx", "topk_scores") else np.asarray(x)
                for f, x in zip(KernelOut._fields, out)
            ])
            self._merge_kernel_metrics(out)
            if _attempt > 0:
                with _STATS_LOCK:
                    STATS["assign_retry_launches"] += 1

            # placement assembly: one shared metrics skeleton per
            # launch; lean asks (no networks/devices/cores — the
            # steady-traffic shape) take the vectorized path, sharing
            # one frozen resources skeleton per (job, tg) and skipping
            # the per-slot assigner entirely (it reads no node state
            # and cannot fail for them). Exact assignment survives for
            # every non-lean ask.
            scaffold = scaffold_for(self.job, tg)
            lean = scaffold.lean_assign
            lean_ports = scaffold.lean_ports
            static_info: Dict[int, Tuple[bool, int]] = {}
            usage = getattr(snapshot, "usage", None)
            oversub = getattr(self.ctx.state.scheduler_config,
                              "memory_oversubscription_enabled", False)
            proto = self._metrics_proto(out)
            found_l = out.found.tolist()
            chosen_l = out.chosen.tolist()
            scores_l = out.scores.tolist()
            node_cache: Dict[int, object] = {}
            dead_rows: set = set()
            retry: List[int] = []
            for slot, ri in enumerate(pending):
                if not found_l[slot]:
                    results[ri] = None
                    continue
                row = chosen_l[slot]
                if row in dead_rows:
                    retry.append(ri)
                    continue
                node = node_cache.get(row)
                if node is None:
                    node = snapshot.node_by_id(c.node_ids[row])
                    if node is None:
                        exclude[row] = True
                        dead_rows.add(row)
                        retry.append(ri)
                        continue
                    node_cache[row] = node
                if lean:
                    task_res, lifecycles, res = \
                        scaffold.lean_planes(oversub)
                    option = SelectedOption(
                        node_id=node.id,
                        node=node,
                        final_score=scores_l[slot],
                        task_resources=task_res,
                        task_lifecycles=lifecycles,
                        alloc_resources=None,
                        metrics=None,
                        resources=res,
                    )
                elif lean_ports and self._lean_port_slot_ok(
                        scaffold, row, node, usage, ev, static_info):
                    option = self._lean_port_option(
                        scaffold, tg, node, oversub, scores_l[slot])
                else:
                    asg = assigners.get(row)
                    if asg is None:
                        asg = _NodeAssigner(node, self.ctx)
                        assigners[row] = asg
                    option = asg.assign(tg, scores_l[slot])
                    if option is None:
                        # exact assignment failed: mask node, re-run
                        # this slot
                        exclude[row] = True
                        dead_rows.add(row)
                        retry.append(ri)
                        continue
                option.metrics = self._metrics_for(proto, slot)
                results[ri] = option
                accepted_rows.append(row)
            if not retry:
                break
            pending = retry
        return results

    def _lean_port_slot_ok(self, scaffold, row: int, node, usage,
                           ev: EvalTensors, static_info: Dict) -> bool:
        """Whether a static-port lean placement on ``node`` is provably
        collision-free WITHOUT building a NetworkIndex: the exact
        assigner for such an ask reads node state only for the
        collision re-check, so when every collision source is provable
        from planes — agent-reserved bits (cluster.port_words), live
        alloc bits (the usage index's port bitmaps), in-plan/accepted
        bits (ev.port_conflict_words) — assignment is pure struct
        building. Any unprovable case (multi-address node, poisoned
        bitmap row, staged stops that would free ports, a live-vs-
        static collision the assigner would fail on) returns False and
        the slot takes the exact ``_NodeAssigner`` path unchanged."""
        info = static_info.get(row)
        if info is None:
            sok = True
            smask = 0
            ips = {nt.ip or "0.0.0.0"
                   for nt in node.node_resources.networks if nt.device}
            if len(ips) > 1:
                sok = False
            else:
                for p in getattr(node.reserved_resources,
                                 "networks_ports", []):
                    if p < 0 or p >= 65536 or (smask >> p) & 1:
                        sok = False
                        break
                    smask |= 1 << p
            info = static_info[row] = (sok, smask)
        if not info[0]:
            return False
        if usage is None:
            return False
        urow = usage.rows.get(node.id)
        if urow is None or urow in usage.port_dirty:
            return False
        live = usage.port_masks.get(urow, 0)
        if live & (scaffold.static_port_mask | info[1]):
            # ask conflicts with a live alloc, or a live alloc already
            # collides with the agent-reserved set (the assigner's
            # add_allocs would fail the whole node)
            return False
        plan = self.ctx.plan
        if node.id in plan.node_update or node.id in plan.node_preemptions:
            # staged stops free ports the snapshot planes still count
            return False
        c = self.cluster
        words = c.port_words[row] | ev.port_conflict_words[row]
        if np.any(words & ev.ask.port_mask):
            return False
        return True

    def _lean_port_option(self, scaffold, tg, node, oversub: bool,
                          final_score: float) -> SelectedOption:
        """The static-port placement structs, mirroring the assigner's
        group-network branch (same offer/NetworkResource shapes) with
        the (job, tg)-shared task skeletons."""
        task_res, lifecycles, _ = scaffold.lean_planes(oversub)
        net = tg.networks[0]
        offer = [Port(label=p.label, value=p.value, to=p.to,
                      host_network=p.host_network)
                 for p in net.reserved_ports]
        nw = NetworkResource(
            mode=net.mode,
            device=(node.node_resources.networks[0].device
                    if node.node_resources.networks else ""),
            ip=(node.node_resources.networks[0].ip
                if node.node_resources.networks else ""),
            reserved_ports=list(offer),
        )
        shared = AllocatedSharedResources(
            disk_mb=tg.ephemeral_disk.size_mb,
            networks=[nw],
            ports=offer,
        )
        res = AllocatedResources(
            tasks=task_res,
            task_lifecycles=lifecycles,
            shared=shared,
        )
        return SelectedOption(
            node_id=node.id,
            node=node,
            final_score=final_score,
            task_resources=task_res,
            task_lifecycles=lifecycles,
            alloc_resources=shared,
            metrics=None,
            resources=res,
        )

    def _apply_accepted(self, ev: EvalTensors, row: int) -> None:
        """Re-apply one already-accepted placement's resources to freshly
        rebuilt eval tensors (retry attempts must not double-book)."""
        if not ev.used_cpu.flags.writeable:
            # the build shared the cluster's read-only gathered usage
            # planes; this eval now diverges — copy-on-write
            ev.used_cpu = ev.used_cpu.copy()
            ev.used_mem = ev.used_mem.copy()
            ev.used_disk = ev.used_disk.copy()
            ev.used_cores = ev.used_cores.copy()
            ev.used_mbits = ev.used_mbits.copy()
        # same COW for the neutral singletons the build shares by
        # identity (frozen: a missed copy raises, never corrupts)
        for f in ("free_dyn_delta", "job_tg_count", "job_any_count",
                  "dev_free", "port_conflict_words"):
            plane = getattr(ev, f)
            if not plane.flags.writeable:
                setattr(ev, f, plane.copy())
        ask = ev.ask
        ev.used_cpu[row] += ask.cpu
        ev.used_mem[row] += ask.mem
        ev.used_disk[row] += ask.disk
        ev.used_cores[row] += ask.cores
        ev.used_mbits[row] += ask.total_mbits
        ev.free_dyn_delta[row] += ask.n_dyn_ports
        ev.job_tg_count[row] += 1
        ev.job_any_count[row] += 1
        ev.dev_free[row] -= ask.dev_counts
        ev.port_conflict_words[row] |= ask.port_mask
        for sp in ev.spreads:
            b = int(sp.bucket_id[row])
            if b >= 0:
                sp.counts[b] += 1

    def select(self, tg, request: Optional[SelectRequest] = None) -> Optional[SelectedOption]:
        """Single-placement compatibility entry (stack.go Select)."""
        return self.select_many(tg, [request or SelectRequest()])[0]

    # -- preemption fallback (SelectOptions.Preempt second pass) ---------

    def select_preempting(self, tg, request: Optional[SelectRequest] = None) -> Optional[SelectedOption]:
        """Place one alloc by evicting lower-priority work.

        Reference: BinPackIterator's preempt branch (rank.go:258-268 area)
        + PreemptionScoringIterator (rank.go:799), invoked via
        SelectOptions.Preempt (generic_sched.go:800-819). TPU split:
        candidate nodes and their upper-bound scores come from one numpy
        sweep over the planes; the exact greedy eviction set runs only
        for the ranked top candidates.
        """
        from nomad_tpu_torch.scheduler.preemption import (
            Preemptor,
            net_priority,
            preemptible_planes,
            preemption_score,
        )

        c = self.cluster
        snapshot = self.ctx.state
        job = self.job
        if job is None:
            return None
        ev = self._build_eval_tensors(tg, np.zeros(c.n_pad, bool))
        ask = ev.ask
        pre_cpu, pre_mem, pre_disk, pre_score = preemptible_planes(
            c, snapshot, self.ctx, job.priority, job.namespace, job.id
        )
        free_cpu = c.cap_cpu - ev.used_cpu + pre_cpu
        free_mem = c.cap_mem - ev.used_mem + pre_mem
        free_disk = c.cap_disk - ev.used_disk + pre_disk
        cand = (
            ev.base_mask
            & ((pre_cpu > 0) | (pre_mem > 0) | (pre_disk > 0))
            & (free_cpu >= ask.cpu)
            & (free_mem >= ask.mem)
            & (free_disk >= ask.disk)
        )
        rows = np.nonzero(cand)[0]
        if rows.size == 0:
            return None

        # upper-bound score per candidate: binpack fit after hypothetical
        # full eviction, averaged with the preemption-score plane (the
        # exact set can only evict less, scoring no worse on fit)
        util_cpu = ev.used_cpu[rows] - pre_cpu[rows] + ask.cpu
        util_mem = ev.used_mem[rows] - pre_mem[rows] + ask.mem
        with np.errstate(divide="ignore", invalid="ignore"):
            fc = np.where(c.cap_cpu[rows] > 0, 1.0 - util_cpu / c.cap_cpu[rows], 0.0)
            fm = np.where(c.cap_mem[rows] > 0, 1.0 - util_mem / c.cap_mem[rows], 0.0)
        total = np.power(10.0, fc) + np.power(10.0, fm)
        if self.ctx.state.scheduler_config.effective_algorithm() == consts.SCHEDULER_ALGORITHM_SPREAD:
            fit = np.clip(total - 2.0, 0.0, 18.0) / 18.0
        else:
            fit = np.clip(20.0 - total, 0.0, 18.0) / 18.0
        # rescheduling-penalty / preferred-node planes from the request
        # (NodeReschedulingPenaltyIterator rank.go:630 appends -1 for
        # penalized nodes; the preferred node is examined first)
        request = request or SelectRequest()
        penalty_rows = {
            c.index[nid] for nid in request.penalty_nodes if nid in c.index
        }
        penalized = np.array([int(r) in penalty_rows for r in rows], bool)
        est = np.where(
            penalized,
            (fit + pre_score[rows] - 1.0) / 3.0,
            (fit + pre_score[rows]) / 2.0,
        )
        preferred_row = c.index.get(request.preferred_node, -1)
        if preferred_row >= 0:
            est = np.where(rows == preferred_row, est + 2.0, est)
        order = np.argsort(-est)

        # LimitIterator semantics: examine a bounded candidate prefix
        limit = max(2, int(math.log2(max(2, c.n_real))))
        plan = self.ctx.plan
        staged = [
            a for allocs in plan.node_preemptions.values() for a in allocs
        ]
        preemptor = Preemptor(job.priority, job.namespace, job.id)

        best_option: Optional[SelectedOption] = None
        best_score = -float("inf")
        examined = 0
        for pos in order:
            if examined >= limit and best_option is not None:
                break
            examined += 1
            row = int(rows[pos])
            node = snapshot.node_by_id(c.node_ids[row])
            if node is None:
                continue
            proposed = self.ctx.proposed_allocs(node.id)
            preemptor.set_node(node)
            preemptor.set_candidates(proposed)
            preemptor.set_preemptions(staged)
            ask_cr = _tg_comparable_ask(tg)
            victims = preemptor.preempt_for_task_group(ask_cr)
            if not victims:
                continue
            victim_ids = {a.id for a in victims}
            remaining = [a for a in proposed if a.id not in victim_ids]
            asg = _NodeAssigner(node, self.ctx, proposed=remaining)
            option = asg.assign(tg, 0.0)
            if option is None:
                continue
            p_score = preemption_score(net_priority(victims))
            planes = [float(fit[pos]), p_score]
            if penalized[pos]:
                planes.append(-1.0)
            final = sum(planes) / len(planes)
            if final > best_score:
                best_score = final
                option.final_score = final
                option.preempted_allocs = victims
                m = self.ctx.metrics().copy()
                m.score_meta.append(
                    (node.id, {"binpack": float(fit[pos]),
                               "preemption": p_score}, final)
                )
                option.metrics = m
                best_option = option
        return best_option

    # -- tensor builders -------------------------------------------------

    def _base_mask(self, scaffold, job, tg, job_allocs_by_node,
                   exclude: np.ndarray) -> np.ndarray:
        """Compiled-mask fast path with Python-builder fallback.

        The compiled path returns the mask-program cache's FROZEN
        array when the eval carries no dynamic state — wave members of
        equal job specs then share one base-mask plane by identity
        (shipped once per wave). An uncompilable tree falls back to
        ``FeasibilityBuilder.base_mask``, which is the semantics
        definition the compiler is property-tested against; an error
        in the compiled path propagates."""
        from nomad_tpu_torch.feasibility import apply_program, default_mask_cache

        if scaffold.program is not None:
            return apply_program(
                scaffold.program, self.cluster, self.ctx.state,
                self.ctx, job, tg, job_allocs_by_node, exclude,
                self._feas)
        default_mask_cache.note_fallback()
        base = self._feas.base_mask(job, tg, job_allocs_by_node)
        base &= ~exclude
        return base

    def _build_eval_tensors(self, tg, exclude: np.ndarray) -> EvalTensors:
        with tracer.span("sched.assembly"):
            return self._build_eval_tensors_inner(tg, exclude)

    def _build_eval_tensors_inner(self, tg, exclude: np.ndarray) -> EvalTensors:
        c = self.cluster
        snapshot = self.ctx.state
        job = self.job
        n = c.n_pad
        scaffold = scaffold_for(job, tg)

        job_allocs = snapshot.allocs_by_job(job.namespace, job.id)
        # distinct_hosts/property masks see PROPOSED allocs (feasible.go
        # uses ctx.ProposedAllocs): exclude plan-staged stops/preemptions,
        # include plan placements
        plan = self.ctx.plan
        staged_out = {
            a.id
            for allocs in list(plan.node_update.values())
            + list(plan.node_preemptions.values())
            for a in allocs
        }
        staged_in = {
            a.id for allocs in plan.node_allocation.values() for a in allocs
        }
        job_allocs_by_node: Dict[str, List] = {}
        for a in job_allocs:
            if a.id in staged_out or a.id in staged_in:
                continue
            job_allocs_by_node.setdefault(a.node_id, []).append(a)
        for allocs in plan.node_allocation.values():
            for a in allocs:
                if a.job_id == job.id:
                    job_allocs_by_node.setdefault(a.node_id, []).append(a)

        with tracer.span("sched.feasibility"):
            base = self._base_mask(scaffold, job, tg,
                                   job_allocs_by_node, exclude)

        # neutral O(n) planes are frozen singletons shared BY IDENTITY
        # across evals (and so shipped once per coalesced wave); any
        # path that actually writes one allocates its own copy
        neutral = neutral_planes(n)
        job_tg_count = neutral.zeros_i32
        job_any_count = neutral.zeros_i32
        conflict_words = neutral_port_words(n, c.port_words.shape[1])
        free_dyn_delta = neutral.zeros_i32

        # plan-skeleton cache: the flattened ask is spec-derived and
        # shared across wave members / retry attempts of the job
        ask = scaffold.ask

        u = getattr(snapshot, "usage", None)
        if (u is not None and not plan.node_update
                and not plan.node_preemptions and not plan.node_allocation):
            # empty plan (first placements of the eval): the proposed
            # utilization IS the snapshot's — share the cluster's
            # read-only gathered planes BY IDENTITY, so every eval of a
            # wave ships one copy to the device instead of one each
            used_cpu, used_mem, used_disk, used_cores, used_mbits = \
                c.gathered_usage(u)
            live_job_allocs = [a for a in job_allocs
                               if not a.terminal_status()]
            if live_job_allocs:
                job_tg_count = np.zeros(n, np.int32)
                job_any_count = np.zeros(n, np.int32)
                for a in live_job_allocs:
                    row = c.index.get(a.node_id)
                    if row is None:
                        continue
                    job_any_count[row] += 1
                    if a.task_group == tg.name:
                        job_tg_count[row] += 1
        else:
            used_cpu = np.zeros(n, np.float32)
            used_mem = np.zeros(n, np.float32)
            used_disk = np.zeros(n, np.float32)
            used_mbits = np.zeros(n, np.int32)
            used_cores = np.zeros(n, np.int32)
            job_tg_count = np.zeros(n, np.int32)
            job_any_count = np.zeros(n, np.int32)
            conflict_words = np.zeros((n, c.port_words.shape[1]), np.uint32)
            free_dyn_delta = np.zeros(n, np.int32)
            # proposed utilization per node (context.go ProposedAllocs
            # over every node)
            self._accumulate_usage(
                used_cpu, used_mem, used_disk, used_mbits, used_cores,
                job_tg_count, job_any_count, conflict_words,
                free_dyn_delta, tg, ask,
            )
        # node-static plane, shared from the cluster build (read-only)
        avail_mbits = (c.avail_mbits if c.avail_mbits is not None
                       else neutral.zeros_i32)

        # live-port conflict overlay for reserved-port asks: sparse
        # walk of the usage index's per-node port bitmaps (only nodes
        # holding ports have entries; poisoned rows stay unflagged —
        # the exact assigner arbitrates them). Sound only when the
        # plan stages no stops (a stop would free its ports); the
        # empty-plan fast path above is exactly that case.
        port_live = None
        if (ask.reserved_ports and u is not None
                and (u.port_masks or u.port_dirty)
                and not plan.node_update and not plan.node_preemptions):
            ask_mask_int = 0
            for v in ask.reserved_ports:
                ask_mask_int |= 1 << v
            for urow, mask in u.port_masks.items():
                if mask & ask_mask_int and urow not in u.port_dirty:
                    nid = u.ids[urow] if urow < len(u.ids) else None
                    row = c.index.get(nid) if nid is not None else None
                    if row is None:
                        continue
                    if port_live is None:
                        port_live = np.zeros(n, bool)
                    port_live[row] = True

        # device planes
        dev_free = neutral.zeros_dev
        dev_aff = neutral.zeros_f32
        has_dev_aff = False
        dev_reqs = [d for task in tg.tasks for d in task.resources.devices]
        if dev_reqs:
            dev_free = np.zeros((n, MAX_DEV_REQS), np.float32)
            dev_aff = np.zeros(n, np.float32)
            for i in range(c.n_real):
                if not base[i]:
                    continue
                node = snapshot.node_by_id(c.node_ids[i])
                if node is None:
                    continue
                proposed = self.ctx.proposed_allocs(c.node_ids[i])
                counts, score, has_aff = device_planes_for_node(node, proposed, dev_reqs)
                for r, cnt in enumerate(counts[:MAX_DEV_REQS]):
                    dev_free[i, r] = cnt
                dev_aff[i] = score
                has_dev_aff = has_dev_aff or has_aff

        # affinity plane (NodeAffinityIterator rank.go:674)
        affinities = scaffold.affinities
        aff_score = neutral.zeros_f32
        if affinities:
            aff_score = np.zeros(n, np.float32)
            sum_weight = sum(abs(float(a.weight)) for a in affinities)
            cache: Dict[str, float] = {}
            for i in range(c.n_real):
                if not base[i]:
                    continue
                cls = c.computed_classes[i]
                if cls in cache and not self.ctx.eligibility.has_escaped():
                    aff_score[i] = cache[cls]
                    continue
                node = snapshot.node_by_id(c.node_ids[i])
                if node is None:
                    continue
                total = sum(
                    float(a.weight) for a in affinities if matches_affinity(a, node)
                )
                score = total / sum_weight if sum_weight else 0.0
                aff_score[i] = score
                cache[cls] = score

        spreads = self._build_spreads(tg, job_allocs)

        return EvalTensors(
            base_mask=base,
            used_cpu=used_cpu,
            used_mem=used_mem,
            used_disk=used_disk,
            used_mbits=used_mbits,
            avail_mbits=avail_mbits,
            used_cores=used_cores,
            port_conflict_words=conflict_words,
            free_dyn_delta=free_dyn_delta,
            dev_free=dev_free,
            dev_aff_score=dev_aff,
            has_dev_affinity=has_dev_aff,
            job_tg_count=job_tg_count,
            job_any_count=job_any_count,
            distinct_hosts_job=scaffold.distinct_hosts_job,
            distinct_hosts_tg=scaffold.distinct_hosts_tg,
            penalty=neutral.zeros_bool,
            aff_score=aff_score,
            has_affinities=bool(affinities),
            spreads=spreads,
            ask=ask,
            desired_count=tg.count,
            algorithm=self.ctx.state.scheduler_config.effective_algorithm(),
            port_live_conflict=port_live,
        )

    def _accumulate_usage(
        self, used_cpu, used_mem, used_disk, used_mbits, used_cores,
        job_tg_count, job_any_count, conflict_words, free_dyn_delta, tg, ask,
    ) -> None:
        """Fold proposed allocs (state + in-flight plan) into the planes."""
        c = self.cluster
        snapshot = self.ctx.state
        plan = self.ctx.plan
        job = self.job

        stopping = {
            a.id
            for allocs in list(plan.node_update.values())
            + list(plan.node_preemptions.values())
            for a in allocs
        }
        # in-plan placements override same-ID state rows (in-place
        # updates) rather than double counting (context.go:193-207)
        planned_ids = {
            a.id for allocs in plan.node_allocation.values() for a in allocs
        }

        def add_alloc(a, sign: float) -> None:
            row = c.index.get(a.node_id)
            if row is None:
                return
            cr = a.comparable_resources()
            used_cpu[row] += sign * cr.cpu_shares
            used_mem[row] += sign * cr.memory_mb
            used_disk[row] += sign * cr.disk_mb
            used_cores[row] += int(sign) * len(cr.reserved_cores)
            for net in cr.networks:
                used_mbits[row] += int(sign) * net.mbits
            if a.job_id == job.id:
                job_any_count[row] += int(sign)
                if a.task_group == tg.name:
                    job_tg_count[row] += int(sign)

        u = getattr(snapshot, "usage", None)
        if u is not None:
            # fast path: gather the store's live utilization planes
            # (state/usage.py) instead of scanning every alloc, then
            # correct for this plan's staged stops and in-plan updates
            perm, valid = c.usage_perm(u)
            np.copyto(used_cpu, np.where(valid, u.used_cpu[perm], 0.0))
            np.copyto(used_mem, np.where(valid, u.used_mem[perm], 0.0))
            np.copyto(used_disk, np.where(valid, u.used_disk[perm], 0.0))
            np.copyto(used_cores, np.where(valid, u.used_cores[perm], 0))
            np.copyto(used_mbits, np.where(valid, u.used_mbits[perm], 0))
            for aid in stopping | planned_ids:
                old = snapshot.alloc_by_id(aid)
                if old is not None and not old.terminal_status():
                    row = c.index.get(old.node_id)
                    if row is None:
                        continue
                    cr = old.comparable_resources()
                    used_cpu[row] -= cr.cpu_shares
                    used_mem[row] -= cr.memory_mb
                    used_disk[row] -= cr.disk_mb
                    used_cores[row] -= len(cr.reserved_cores)
                    for net in cr.networks:
                        used_mbits[row] -= net.mbits
            # job-local planes from the per-job index (small)
            for a in snapshot.allocs_by_job(job.namespace, job.id):
                if a.terminal_status() or a.id in stopping or a.id in planned_ids:
                    continue
                row = c.index.get(a.node_id)
                if row is None or a.job_id != job.id:
                    continue
                job_any_count[row] += 1
                if a.task_group == tg.name:
                    job_tg_count[row] += 1
        else:
            for a in snapshot.allocs_iter():
                if a.terminal_status() or a.id in stopping or a.id in planned_ids:
                    continue
                add_alloc(a, 1.0)
        for allocs in plan.node_allocation.values():
            for a in allocs:
                add_alloc(a, 1.0)
                # in-plan port usage -> conflict words + dyn delta
                row = c.index.get(a.node_id)
                if row is None or a.allocated_resources is None:
                    continue
                for tr in a.allocated_resources.tasks.values():
                    for net in tr.networks:
                        for p in list(net.reserved_ports) + list(net.dynamic_ports):
                            conflict_words[row, p.value >> 5] |= np.uint32(
                                1 << (p.value & 31)
                            )
                            if 20000 <= p.value <= 32000:
                                free_dyn_delta[row] += 1
                for p in a.allocated_resources.shared.ports:
                    conflict_words[row, p.value >> 5] |= np.uint32(1 << (p.value & 31))
                    if 20000 <= p.value <= 32000:
                        free_dyn_delta[row] += 1

    def _build_spreads(self, tg, job_allocs) -> List[SpreadTensor]:
        """SpreadIterator state -> SpreadTensor list (spread.go:82-113,
        computeSpreadInfo :245)."""
        c = self.cluster
        job = self.job
        combined = list(tg.spreads) + list(job.spreads)
        if not combined:
            return []
        sum_weights = sum(abs(s.weight) for s in combined)
        out = []
        plan_allocs = [
            a
            for allocs in self.ctx.plan.node_allocation.values()
            for a in allocs
            if a.job_id == job.id and a.task_group == tg.name
        ]
        live_allocs = [
            a
            for a in job_allocs
            if not a.terminal_status() and a.task_group == tg.name
        ] + plan_allocs
        node_of = {nid: i for i, nid in enumerate(c.node_ids)}
        for spread in combined:
            # value table: desired targets first, then observed node values
            values: Dict[str, int] = {}
            for t in spread.spread_target:
                if t.value != "*":
                    values.setdefault(t.value, len(values))
            bucket_id = np.full(c.n_pad, -1, np.int32)
            node_vals: List[Optional[str]] = [None] * c.n_real
            for i in range(c.n_real):
                node = self.ctx.state.node_by_id(c.node_ids[i])
                if node is None:
                    continue
                val, ok = resolve_target(spread.attribute, node)
                if not ok:
                    continue
                node_vals[i] = val
                if val not in values:
                    if len(values) >= SPREAD_BUCKETS:
                        continue  # overflow: value scores as missing
                    values[val] = len(values)
                bucket_id[i] = values[val]
            counts = np.zeros(SPREAD_BUCKETS, np.float32)
            for a in live_allocs:
                row = node_of.get(a.node_id)
                if row is None or node_vals[row] is None:
                    continue
                b = values.get(node_vals[row])
                if b is not None:
                    counts[b] += 1
            desired = np.full(SPREAD_BUCKETS, -1.0, np.float32)
            even = not spread.spread_target
            if not even:
                total_count = float(tg.count)
                sum_desired = 0.0
                implicit_pct = None
                for t in spread.spread_target:
                    dc = (float(t.percent) / 100.0) * total_count
                    if t.value == "*":
                        implicit_pct = dc
                        continue
                    desired[values[t.value]] = dc
                    sum_desired += dc
                # implicit remainder target (spread.go:258-262)
                remainder = total_count - sum_desired
                if implicit_pct is None and 0 < sum_desired < total_count:
                    implicit_pct = remainder
                if implicit_pct is not None:
                    for v, b in values.items():
                        if desired[b] < 0:
                            desired[b] = implicit_pct
                    # nodes with unseen values also get the implicit target:
                    # they were added to the table above, so covered.
            out.append(
                SpreadTensor(
                    bucket_id=bucket_id,
                    counts=counts,
                    desired=desired,
                    weight_frac=float(spread.weight) / float(sum_weights) if sum_weights else 0.0,
                    even=even,
                )
            )
        return out

    def _merge_kernel_metrics(self, out: KernelOut) -> None:
        """Fold the kernel's mask-population counts into the eval
        context metrics so failed placements report why (the blocked
        eval's FailedTGAllocs carries these, eval_endpoint surface)."""
        m = self.ctx.metrics()
        m.nodes_evaluated = int(out.nodes_evaluated)
        m.nodes_exhausted = int(out.nodes_evaluated - out.nodes_feasible)
        for dim, cnt in (
            ("cpu", out.exhausted_cpu),
            ("memory", out.exhausted_mem),
            ("disk", out.exhausted_disk),
            ("network: dynamic port selection failed", out.exhausted_ports),
            ("devices", out.exhausted_devices),
            ("cores", out.exhausted_cores),
        ):
            if int(cnt) > 0:
                m.dimension_exhausted[dim] = int(cnt)

    def _metrics_proto(self, out: KernelOut) -> MetricsSkeleton:
        """Per-launch MetricsSkeleton (scheduler/scaffold.py): the
        header counts are identical for every slot, captured once; the
        top-k planes ride the skeleton UNRESOLVED (device arrays or
        the coalescer's lazy wave slices) — their single d2h fetch and
        the score_meta materialization are DEFERRED onto the plan's
        post-processing queue (plan.deferred_work), so they run inside
        the batching worker's plan window — overlapping the next
        wave's execute — instead of on the wave-critical eval path."""
        dim_exhausted = {}
        for dim, cnt in (
            ("cpu", out.exhausted_cpu),
            ("memory", out.exhausted_mem),
            ("disk", out.exhausted_disk),
            ("network: dynamic port selection failed", out.exhausted_ports),
            ("devices", out.exhausted_devices),
            ("cores", out.exhausted_cores),
        ):
            if int(cnt) > 0:
                dim_exhausted[dim] = int(cnt)
        m = self.ctx.metrics()
        return MetricsSkeleton(
            nodes_evaluated=int(out.nodes_evaluated),
            nodes_filtered=m.nodes_filtered,
            nodes_exhausted=int(out.nodes_evaluated - out.nodes_feasible),
            constraint_filtered=dict(m.constraint_filtered),
            dimension_exhausted=dim_exhausted,
            topk_idx=out.topk_idx,
            topk_scores=out.topk_scores,
        )

    def _metrics_for(self, proto: MetricsSkeleton, slot: int) -> AllocMetric:
        m = proto.materialize()
        # score_meta fills in place before the plan applies (the
        # Allocation holds this same AllocMetric object by reference)
        self.ctx.plan.deferred_work.append(
            lambda m=m, proto=proto, slot=slot: self._fill_score_meta(
                m, proto, slot))
        return m

    def _fill_score_meta(self, m: AllocMetric, proto: MetricsSkeleton,
                         slot: int) -> None:
        c = self.cluster
        rows, scores = proto.slot_topk(slot)
        for row, score in zip(rows.tolist(), scores.tolist()):
            if score <= NEG_INF / 2:
                continue
            if row < c.n_real:
                m.score_meta.append(
                    (c.node_ids[row], {"normalized-score": score}, score)
                )


def _tg_comparable_ask(tg) -> "ComparableResources":
    """Flatten a task group's total ask to ComparableResources (the
    resourceAsk.Comparable() the Preemptor scores against)."""
    from nomad_tpu_torch.structs.resources import ComparableResources

    ask = ComparableResources(disk_mb=int(tg.ephemeral_disk.size_mb))
    for task in tg.tasks:
        ask.cpu_shares += int(task.resources.cpu)
        ask.memory_mb += int(task.resources.memory_mb)
    return ask


class _NodeAssigner:
    """Exact per-node assignment of ports, devices, and cores for one or
    more placements on the same chosen node (the tail of
    BinPackIterator.Next, rank.go:280-520, run host-side only for
    selected nodes)."""

    def __init__(self, node, ctx: EvalContext, proposed=None) -> None:
        self.node = node
        self.ctx = ctx
        # every sub-assigner is built LAZILY on the first ask that needs
        # it: a lean cpu/mem placement (the common case) pays for none
        # of the port/device/core indexing, which otherwise dominated
        # the per-placement host profile (reference equally only enters
        # these branches for non-empty asks, rank.go:270-492)
        self._proposed = proposed
        self._net_idx: Optional[NetworkIndex] = None
        self._net_ok = True
        self._dev_alloc: Optional[DeviceAllocator] = None
        self._used_cores: Optional[set] = None

    def _get_proposed(self):
        if self._proposed is None:
            self._proposed = self.ctx.proposed_allocs(self.node.id)
        return self._proposed

    @property
    def net_idx(self) -> NetworkIndex:
        if self._net_idx is None:
            self._net_idx = NetworkIndex()
            if self.ctx.port_seed is not None:
                import zlib

                self._net_idx.seed(
                    self.ctx.port_seed ^ zlib.crc32(self.node.id.encode()))
            collide, reason = self._net_idx.set_node(self.node)
            if not collide:
                collide, reason = self._net_idx.add_allocs(
                    self._get_proposed())
            self._net_ok = not collide
            if collide:
                from nomad_tpu_torch.scheduler.context import PortCollisionEvent

                self.ctx.send_event(
                    PortCollisionEvent(reason, node=self.node))
        return self._net_idx

    @property
    def dev_alloc(self) -> DeviceAllocator:
        if self._dev_alloc is None:
            self._dev_alloc = DeviceAllocator(self.node)
            self._dev_alloc.add_allocs(self._get_proposed())
        return self._dev_alloc

    @property
    def used_cores(self) -> set:
        if self._used_cores is None:
            self._used_cores = set()
            for a in self._get_proposed():
                self._used_cores |= set(
                    a.comparable_resources().reserved_cores)
        return self._used_cores

    @used_cores.setter
    def used_cores(self, value: set) -> None:
        self._used_cores = value

    def assign(self, tg, final_score: float) -> Optional[SelectedOption]:
        needs_net = bool(tg.networks) or any(
            t.resources.networks for t in tg.tasks)
        if needs_net:
            self.net_idx          # build + validate
            if not self._net_ok:
                return None
        task_resources: Dict[str, AllocatedTaskResources] = {}
        task_lifecycles: Dict[str, Optional[object]] = {}
        alloc_resources = None

        # group-level networks (rank.go:270-348)
        if tg.networks:
            group_ask = tg.networks[0].copy()
            offer, err = self.net_idx.assign_ports(group_ask)
            if offer is None:
                return None
            self.net_idx.add_reserved_ports(offer)
            nw = NetworkResource(
                mode=group_ask.mode,
                device=(self.node.node_resources.networks[0].device
                        if self.node.node_resources.networks else ""),
                ip=(self.node.node_resources.networks[0].ip
                    if self.node.node_resources.networks else ""),
                reserved_ports=[p for p in offer],
            )
            alloc_resources = AllocatedSharedResources(
                disk_mb=tg.ephemeral_disk.size_mb,
                networks=[nw],
                ports=offer,
            )

        # memory oversubscription (structs.go MemoryMaxMB): the burst
        # ceiling rides on the allocation ONLY when the operator enabled
        # it (SchedulerConfiguration.MemoryOversubscriptionEnabled);
        # scheduling always counts the reserve (memory_mb)
        oversub = getattr(self.ctx.state.scheduler_config,
                          "memory_oversubscription_enabled", False)
        for task in tg.tasks:
            r = task.resources
            tr = AllocatedTaskResources(
                cpu=AllocatedCpuResources(cpu_shares=int(r.cpu)),
                memory=AllocatedMemoryResources(
                    memory_mb=int(r.memory_mb),
                    memory_max_mb=(int(r.memory_max_mb)
                                   if oversub else 0),
                ),
            )
            # task-level legacy networks (rank.go:363-410)
            if r.networks:
                offer, err = self.net_idx.assign_network(r.networks[0])
                if offer is None:
                    return None
                self.net_idx.add_reserved(offer)
                tr.networks = [offer]
            # devices (rank.go:413-460)
            for req in r.devices:
                offer, _weights, err = self.dev_alloc.assign(req)
                if offer is None:
                    return None
                self.dev_alloc.add_reserved(offer)
                tr.devices.append(offer)
            # reserved cores (rank.go:462-492)
            if r.cores > 0:
                avail = [
                    core
                    for core in self.node.node_resources.cpu.reservable_cpu_cores
                    if core not in self.used_cores
                ]
                if len(avail) < r.cores:
                    return None
                tr.cpu.reserved_cores = avail[: r.cores]
                self.used_cores |= set(tr.cpu.reserved_cores)
                tr.cpu.cpu_shares = (
                    self.node.node_resources.cpu.shares_per_core() * r.cores
                )
            task_resources[task.name] = tr
            task_lifecycles[task.name] = task.lifecycle

        return SelectedOption(
            node_id=self.node.id,
            node=self.node,
            final_score=final_score,
            task_resources=task_resources,
            task_lifecycles=task_lifecycles,
            alloc_resources=alloc_resources,
            metrics=AllocMetric(),
        )
