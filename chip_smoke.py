#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's placement paths on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

The quickest proof that the port (``nomad_tpu_torch``) starts and is right
on the GPU. It imports nothing of JAX or of ``nomad_tpu``. Phases:

1. card and build: the card's name and power limit (nvidia-smi), then the
   seven kernel libraries built from csrc/ at once (one nvcc each) with
   ptxas's register/spill report;
2. kernel against its plain torch version at the live shape: a C2M
   cluster of 10k nodes (N=16384) with 100k resident allocs, waves of 32
   members x 10 placements (T=512), six variants of the fused envelope;
3. the main path: 32 threads submit evals through ``LaunchCoalescer`` for
   64 rounds; every wave commits into device-resident used planes; each
   thread's round is split by the host clock into building its member and
   waiting in the launch (park and wave), beside 32 member builds on one
   thread with no other running;
4. the composite on the card: the joint kernel (``csrc/joint_wave.cu``)
   for the waves outside B1's envelope. One wave of each union (a spread
   member among 31 shuffle members; 32 members asking devices, cores or
   bandwidth; 32 asking all four with the kitchen sink's planes) through
   ``launch_wave`` into phase 3's resident usage, each held exactly
   against the plain version on the same inputs: one joint launch and
   one fused fallback a wave, no torch-op wave, no B1 launch, no node
   over capacity. Then each wave's kernel alone against its plain
   version (max abs error 0.0, no near-tie), its CUDA-event ms beside
   the plain version's and its bound, with the plan's cluster count and
   where its rows live, and the same wave forced onto one cluster (bit
   for bit the plan's, timed beside it). Then the node ceiling: a C2M
   cluster of 300k nodes (N=524288, more than B1's cluster holds in
   shared memory) with 1M allocs, a shuffle wave and an everything wave
   through ``launch_wave``: the joint kernel over the clusters its plan
   picks, its rows in shared memory, one launch and one fused fallback
   each, no failure, exact against the plain version, and the kernel's
   time beside the plain version's and the bound; forced onto one
   cluster, the kernel's global-row instantiation, bit for bit the same;
5. scale: two waves at 100k nodes (N=131072) with 1M allocs, kernel
   against plain; then the joint kernel's spread and everything waves
   there, the same way (the plan's clusters beside one);
6. times: CUDA-event time of the kernel and of the plain version at the
   live shape, and the bound;
7. B3, the lean full-width batch kernel, against its plain version on the
   bench's throughput problem (10k nodes, N=16384, B=512, K=10) and at
   100k nodes (N=131072), then the schedule-apply step with the kernel
   inside (the B3 path, 4 batches) against the plain step: same committed
   planes;
8. B2, the candidate-set placement kernel (pass, top-k, rest max and
   scan in one launch), and the batched loop at the bench shape (B=8192,
   25 batches, K=10): the kernel against its plain version on one batch,
   its peak allocation over that batch, then the ``kernel_topk`` loop (the
   B2 path) against the ``torch`` loop, with evals/s of both and the split
   of a batch (kernel, commit, the rest; fallback rows);
9. the replay form: the same loop with ``reset_every=1`` on a C2M cluster
   of 10k nodes with 100k resident allocs;
10. the scheduler path: the C2M replay state (10k nodes, 100k allocs)
    built into the port's ``StateStore`` (``parallel/c2m.generate``), its
    first and incremental ``ClusterTensors`` builds timed; 8 rounds of 32
    new C2M lean jobs, each round's evals run by 32 threads through
    ``new_scheduler`` with ``LaunchCoalescer.launch`` as the launcher and
    plans committed through the ``Harness`` (every wave one B1 launch, 0
    fallbacks, every eval complete with its 10 placements, no node over
    capacity; the resident state's counters, 0 errors, and the upload
    bytes per wave); B1 against its plain version on one wave of round 1's
    recorded members, in a fixed order; then 8 evals one at a time
    through ``default_kernel_launch``, each lean eval's candidate set one
    call of its kernel (``csrc/candidate_set.cu``: the calls must equal
    the candidate sets counted, and every call is held bit for bit to the
    plain version, ``place_taskgroup_topk``, on a copy of its planes),
    then the kernel, the plain version and the full-width joint kernel
    timed on one recorded eval's planes (CUDA events, 10 calls each)
    beside the kernel's bound. Each thread's round is split by the
    host clock into the scheduler before its launch, the launch (park and
    wave) and plan assembly and submit; one ``sched: {...}`` line. Then,
    after the store's bytes are taken for phase 11, one system job (a
    lean node agent on every node) through ``new_scheduler("system",
    ...)`` on the card: ``_feasible_mask`` on the card against the same
    ``KernelIn`` on the CPU (mask and fit planes exact) and against a
    plain fit computed apart (mask exact), for the agent's ask and for
    an ask of the median free cpu and memory (a large share of the nodes
    must not fit), its time by CUDA events beside its bound in bytes,
    and one alloc on every feasible ready node; one ``system: {...}``
    line;
11. the server: phase 10's store, taken as bytes with
    ``to_snapshot_bytes()``, restored into the store of a ``Server`` on
    the card (one worker, batch 32, the JAX bench's e2e shape); 40
    warm-up jobs, then a timed burst of 200 C2M lean jobs (100 in the
    first arm) registered with ``job_register``: the eval broker hands them out in batches, the
    worker's coalescer fires each wave as one B1 launch, and plans commit
    through the plan queue and the applier's group commit. Run three
    times: ``gc_tuning`` off, then on (``gc.freeze()`` runs once per
    process, so the order is fixed), then on with the coalescer's
    adaptive window off; one ``server: {...}`` line per arm (evals/s,
    e2e and plan latency p50/p99, B1 launches, waves and their mean fill,
    fallbacks, plans and rejected node plans, full collections and their
    pause, group commits, the restore's time). Every timed job must have
    its 10 allocations, no node may be over capacity, the broker must end
    empty with no failed eval but one whose plans were rejected five
    times and whose blocked follow-up, released by the leader's
    failed-eval unblock loop (each minute, Nomad's
    periodicUnblockFailedEvals), completed, and B1 must have launched
    fewer times than there were evals. Each arm prints how many evals
    that loop released in its burst and how many failed so. Each arm
    also reports the device-resident cluster
    state's counters over the burst (hits, scatter advances, rows, full
    uploads, forks, evictions, errors: any error fails the run) and the
    wave launcher's upload bytes per wave; after the window-off arm, the
    resident generation of the store's final snapshot must equal a fresh
    ``ClusterTensors.build`` of it uploaded whole (``torch.equal``, plane
    by plane), and the dirty-row scatter is timed on the card (320 rows
    of the five usage planes, CUDA events). Then one arm at the server's
    default ``worker_batch_size`` of 1: 40 warm-up jobs, then 40 lean
    jobs, each eval through the single-eval launcher (no B1 launch), its
    candidate set one call of the candidate-set kernel; evals/s, e2e
    p50/p99, the single evals' route and the kernel's calls;
12. the warm start: phase 11's snapshot bytes, written once to a
    temporary file, restored in three fresh Python processes (no CUDA
    context, no kernel library loaded) into a server with
    ``kernel_warmup=True``, one manifest path, the window off and the
    kernel profiler on; each runs the 200-job timed burst. Run A finds no
    manifest and persists one at shutdown; run B warms it at ``start()``
    and waits for the warmup before its burst; run C warms it and bursts
    at once. Each reports the time from ``start()`` to the first wave's
    completion, the first wave's latency and assembly, the profiler's
    stages, bytes, dispatches and misses in the burst, evals/s, e2e
    p50/p99, and B1 launches against waves; runs B and C must warm at
    least one entry and fail none, and run B must miss no key in its
    burst. One ``warm start: {...}`` line per run;
13. worker processes: phase 11's window-off server with
    ``scheduler_workers=2``, then 4, each process opening the card and
    placing its leases through B1, its waves taking the placement turn
    in order; the 40 warm-up jobs, then the timed burst of 200 with
    every count, the processes' own included, set to 0 just before it.
    Per arm: evals/s, e2e and plan latency, rejected node plans, turns
    granted and the wait for one, waves, fill and B1 launches per
    process, lease reissues, the IPC round trip, bootstrap-frame bytes
    and seconds and first-wave latency per process, their resident
    memory. Every job placed, no node over capacity, no failed eval, no
    fallback or failure and no device-state error in any process, every
    process that took an eval with its B1 launches and the card's name,
    the busiest process's resident planes equal to a fresh upload, the
    usage planes equal to a rebuild, no generation lease left after
    shutdown. The first arm then registers a system and a sysbatch node
    agent: each eval complete, one alloc on every feasible ready node
    and on no other, the mask held against the CPU and a plain fit. One
    ``workerproc: {...}`` line per arm, and phase 11's window-off arm as
    the arm without;
14. a raft cluster (``chip_smoke.py --raft-cluster <state> <out.json>``,
    a child process): three servers with phase 11's window-off settings,
    each with its own data dir (WAL, stable store, snapshots; fsync
    policy ``batch``), over the in-memory transport with the cluster
    timers of ``server/testing.py`` (heartbeat 50 ms, election 300-600
    ms). Each store restores phase 11's snapshot bytes before
    ``start()``; once a leader is up every node snapshots that state into
    its data dir. The 40 warm-up jobs, then the timed burst of 200,
    registered by a thread with whichever server leads; when half of it
    is placed the leader is killed (``hard_kill``) between two
    registrations, the burst converges on the two survivors, and the
    killed server is restarted from its data dir until it has applied
    the leader's commit index and the three stores are equal. Gates: one
    leader at a time and no leadership change in the burst but the
    kill; B1 launches on the first leader and on the new one, 0
    fallbacks and failures; once the new leader is established, every
    request for resident planes names its store, and its resident planes
    equal a fresh upload; every job with its 10 allocs, unique by name, none
    over capacity, no failed eval, an empty broker, no worker error in
    the burst (one before it only on a server whose leadership was
    revoked: the acks its flushed broker refused); after the restart,
    equal stores (index, allocs by id, node and status), usage planes
    equal to a rebuild on each, a recovered snapshot; a valid failover
    timeline. It reports evals/s before and after the kill, e2e and plan
    latency, WAL fsync and entries per fsync, the quorum latency, the
    failover (kill, leader won, established, the new leader's first
    wave, converged; the timeline's phases), the restart's recovery and
    catch-up, resident generations and bytes, the interpreter's stalls,
    worker errors before the burst, thread errors and the child's RSS,
    and the vote threads that an exception ended, counted in the
    child's log (a RequestVote reaching a recovering server; must be 0);
15. the agent: ``python -m nomad_tpu_torch agent -config <file>
    -http-port 0`` in a child process on the card (the config gives phase
    11's window-off shape: one worker, batches of 32, no warmup
    manifest), driven only over its HTTP API and its CLI. Phase 11's
    state goes to it as an operator snapshot (``PUT
    /v1/operator/snapshot``) and ``/v1/nodes`` must list every node
    ready; the 40 warm-up jobs, then the timed burst of 200 through
    ``PUT /v1/jobs`` from 8 client threads, every count reset just
    before it (``PUT /v1/operator/traces`` with ``Reset``); ``job run``
    and ``job status`` of an HCL job through the CLI; ``job plan`` of a
    job that fits (10 places, no failed group); a traced burst of 40,
    its spans reduced to waterfalls. Gates, read from the agent: B1
    launches in the timed burst (the delta of
    ``nomad_tpu_wave_fused_launches_total`` in the Prometheus scrape), 0
    fallbacks, failures and device-state errors; from its snapshot
    (``GET /v1/operator/snapshot``): every job with its 10 allocs unique
    by name, no node over capacity, none of the bursts' evals failed; no
    restored node down; SIGTERM ends the agent with exit 0 within 30 s.
    It reports the restore's seconds, evals/s, the register latency, e2e
    and the plan stages' p50/p99, waves, fill, B1 launches, the ``job
    plan`` seconds, the spans' exclusive p50/p99 and the waterfall's
    split, the child's RSS and the phase's seconds, beside phase 11's
    window-off arm;
16. the client: part A, ``python -m nomad_tpu_torch agent -dev -config
    <file> -http-port 0`` in a child process on the card (server and
    client in one process; phase 15's server block, and a client block
    naming the dev node's class ``card-client``). Phase 11's state goes
    to it as an operator snapshot; the restore drops the dev node, and
    the client registers it again on its next heartbeat: ``/v1/nodes``
    must list every node ready and one of that class. The native
    executor must have built (raw_exec supervises through it). A burst
    of 32 batch jobs of 4 raw_exec tasks (``sh -c 'echo
    "$NOMAD_ALLOC_ID"'``, phase 13's node-agent ask, an ephemeral disk
    of 10 MB) pinned to that class by a constraint, through ``PUT
    /v1/jobs`` from 8 threads, traced and with every count reset just
    before it: B1 places the 128 allocs over the whole cluster's planes.
    Gates: B1 launches (the scrape's delta) at least 1 and fewer than
    the evals, 0 fallbacks, failures and device-state errors; every
    fused wave at the cluster's padded width (N=16384, from the kernel
    profiler's keys); every alloc on the dev node, ``complete``, its
    task dead after one run with exit code 0; each one's stdout log
    (``GET /v1/client/fs/logs``, read as soon as the alloc is complete:
    the client keeps 50 terminal allocs and removes older ones' dirs)
    its own id, and ``alloc logs`` through the CLI the same for one the
    client keeps; what the server committed on the node (its live
    allocs' ``AllocatedResources``, read while the burst runs) never
    over its capacity; no task process left. The client's data dir lies
    under the child's own temp dir. A service job of 2 ``sleep`` tasks
    runs, then ``job stop`` through the CLI ends both. SIGTERM ends the agent with
    exit 0 within 30 s and leaves no task or log collector behind.
    Part B, in this process: a server on the card and a client with the
    CUDA device plugin, whose node must hold one ``nvidia/gpu`` group
    named as ``nvidia-smi`` names the card with
    ``torch.cuda.device_count()`` instances; a job holding the card
    blocks a second that asks for it (no alloc, the ``devices``
    dimension exhausted) until it is stopped; then the second runs and
    prints ``CUDA_VISIBLE_DEVICES``, which must read ``0``. The second
    also spreads over datacenters. The device asks' route is counted:
    the single-eval launcher, no B1 launch, fallback or failure; the
    holder's through the candidate set (one call of its kernel), the
    reader's two
    evals through the full width, one joint-kernel launch each. One
    ``client: {...}`` line: start, restore and
    re-registration seconds, evals/s, waves, fill, B1 launches, register
    → placed → running → complete p50/p99 per alloc from the task
    events' times, the service's start and stop seconds, the child's
    RSS, its stop, part B and the phase's seconds. ``chip_smoke.py
    --client-phase`` runs this phase alone (``--device cpu`` rehearses
    it on the CPU);
17. the node-axis mesh: part A, phase 3's live cluster (10k nodes,
    N=16384, 100k allocs): the process's first sharded waves at D=4, an
    inert one (no active step) then a live one (cold), timed beside
    three repeats of the live one (warm), held against B1; each
    of the six variants' waves of 32 x 10 through the sharded kernel
    (``ck.sharded_wave_place``, ``csrc/sharded_wave.cu``) at D=4 against
    its plain version (``parallel/sharded._sharded_wave`` on the card)
    on the same shards, one kernel call, one kernel launch (the C
    side's count) and a max abs error of 0.0 each, and through
    ``launch_wave(mesh=wave_mesh(devices=[card] * D))`` for D = 2, 4 and
    8 virtual shards on the one card and through the unsharded
    ``launch_wave`` (B1) on the same inputs: choices, found, top-k
    indices and i32 metrics equal, max abs error 0.0 (near-ties counted
    apart), every wave one sharded launch, one kernel call, one kernel
    launch and no B1 launch, its time by CUDA events beside B1's; the
    kernel alone timed at each D beside B1's kernel on the same wave,
    its time an active step, and its plain version once (kitchen sink);
    phase 4's five waves outside the fused envelope (spread, devices,
    cores, bandwidth, everything) through the joint sharded kernel
    (``ck.joint_sharded_wave_place``, ``csrc/joint_sharded_wave.cu``) at
    D=4: through ``launch_wave`` over the mesh (one call, one cluster
    launch, no torch-op wave) against the one-device wave (the joint
    kernel), exact, then the kernel alone against its plain version and
    the one-device joint kernel, exact, timed beside the joint kernel;
    one wave at N=131072 (100k nodes, 1M allocs) at D=8 against B1, and
    the kernel alone on it beside B1's, and the spread and everything
    waves there through the joint sharded kernel the same way (held
    against the one-device joint kernel, whose plain version phase 5
    holds at that width); phase 4's N=524288 waves (300k nodes; shuffle
    and everything) at D=4 on the one card, past one cluster's shared
    memory, the same way (the shuffle wave, in the fused envelope,
    through the joint sharded kernel and one counted fused fallback
    too), with the plan's clusters a card; the mesh
    of the real cards (one card: B1, one counted fallback; more: the
    same parity gate, one kernel launch a card, the kernel alone timed
    over the cards beside B1's, and the everything wave through the
    joint sharded kernel over the cards, at N=16384 and at N=1048576,
    several clusters a card). Part B, the
    resident state split over 4 shards (``configure_mesh``): two waves
    of phase 11's store's own planes with 320 allocs stopped between
    them; the generation advances by the sharded scatter, equals a fresh
    upload split by shard, and every shared plane of both waves is found
    resident (0 B of them uploaded by the launcher). Part C, phase 11's
    window-off server with ``use_device_mesh=True`` (one card: no mesh,
    logged) and ``kernel_warmup=True`` over a manifest of the keys part
    A launched (the kernel profiler is on from part A to the end of the
    phase; the keys seen are forgotten before the server starts) and of
    phase 12's run A (a server of the same shape), then
    ``Server._adopt_wave_mesh`` of a 4-shard virtual mesh, whose
    mesh-only warm pass and the start-up pass are waited for (at least
    one entry warmed, none failed), the 40 warm-up jobs and the timed
    200: no sharded miss in the timed burst, every wave sharded, one
    kernel call and one kernel launch (counts read just before and after
    the burst), no fallback
    or failure, no B1 launch, every job placed, none over capacity, the
    exporter's sharded series equal to the waves and
    ``nomad_tpu_wave_sharded_mesh_devices 4``, evals/s and wave p50
    beside phase 11's window-off arm; then its spread arm, 64 burst jobs
    spread over the datacenters: every wave sharded, every one outside
    the envelope one call of the joint sharded kernel and one cluster
    launch, no torch-op wave, no B1 launch, no failure, every job placed,
    none over capacity. One ``mesh: {...}`` line, and the sharded
    kernels' entries in the kernels' JSON line.
    ``chip_smoke.py --mesh-phase`` runs phase 12's three fresh
    processes over a mesh (``run_mesh_warm_start``), then phase 11's
    window-off arm and this phase alone, then phase 18 (over four cards
    when the host has them; ``--device cpu`` rehearses them);
18. the batched placement step over an (evals, nodes) mesh
    (``run_place_batch_phase``): ``entry.dryrun_multichip(8)`` over eight
    virtual positions of the card (its asserts, then a live server whose
    waves run over them); then ``sharded.make_place_batch`` at full width
    (32 evals x 10 placements, 10,000 nodes, N=16384, each eval its own
    planes): the dry run's mix (a spread on every even eval) and an
    all-lean batch over a (2, 4) mesh, where each eval in the fused
    envelope is one sharded-kernel call, and the all-lean batch and the
    mix over a (2, 1) mesh, where a lean eval is one B1 call and a spread
    eval one joint-kernel call; over (2, 4) a spread eval is one call of
    the joint sharded kernel. Counts set to 0 just before the four
    batches' first routed calls and read just after: 32 kernel calls in
    each (16 of the mix's joint sharded calls over (2, 4), 16 joint calls
    over (2, 1)), no plain eval, one cluster launch a card a sharded
    call. Each batch against the plain
    step (every eval through the torch-op body) on the card: i32 outputs
    exact, scores within ATOL, near-ties counted apart; CUDA-event ms a
    batch beside the plain step's and beside placing its leaves, and
    ``place_batch_bound``. One ``place batch: {...}`` line. ``chip_smoke.py --place-batch-phase``
    runs it alone (over four cards, a (2, 2) mesh and the dry run at 4,
    when the host has them).

Any mismatch exits non-zero without the final line. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit, and before that the kernels' JSON line (B1's entry
counts its launches on the main path of phase 3 under ``launches``, on
the scheduler path of phase 10 under ``sched_launches``, on phase 11's
timed server bursts under ``server_launches`` and in phase 13's worker
processes' timed bursts under ``workerproc_launches``, in phase 14's
timed burst, both leaders', under ``raft_launches``, in phase 15's
timed burst, read from the agent's scrape, under ``agent_launches``,
in phase 16's burst of client jobs under ``client_launches``, and in
phase 17's unsharded reference waves under ``mesh_launches`` and in
phase 18's batches under ``place_batch_launches``; the warm-up launches
of phase 12 are counted apart, in its child processes; the joint
kernel's entry counts its launches in phase 4's waves, in phase 16 part
B under ``client_launches`` and in phase 18 under
``place_batch_launches``; the sharded
kernel's entry counts its calls in phase 17's timed server burst, its
kernel launches there under ``cluster_launches``, and its calls in
phase 18's batches under ``place_batch_launches``; the joint sharded
kernel's counts its calls in phase 17 part C's spread arm, its kernel
launches there under ``cluster_launches``, and its calls in phase 18's
batches under ``place_batch_launches``; the candidate-set kernel's counts
its calls in phase 10's single evals, in phase 11's batch-of-one burst
under ``server_batch1_launches`` and in phase 16 part B under
``client_launches``).
A full
record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops.kernel import (
    FUSED_METRIC_FIELDS,
    LEAN_FEATURES,
    KernelOut,
    MAX_PENALTY_NODES,
    TOPK,
    _upload_kin,
    build_kernel_in,
    canonical_features,
    neutral_planes,
    pad_steps,
    place_taskgroup_topk,
    single_eval_stats,
    unpack_fused_wave,
)
from nomad_tpu_torch.parallel import batching, c2m, coalesce, sharded
from nomad_tpu_torch.parallel import mesh as pmesh
from nomad_tpu_torch.parallel.synthetic import (
    C2M_SHAPE_CPU,
    C2M_SHAPE_MEM,
    C2M_SHAPE_P,
    c2m_cluster,
    c2m_pack_usage,
    synthetic_eval,
    throughput_problem,
)
from nomad_tpu_torch.scheduler import new_scheduler
from nomad_tpu_torch.scheduler import system as system_sched
from nomad_tpu_torch.scheduler.testing import Harness
from nomad_tpu_torch.server.plan_apply import plan_group_stats
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.ops import warmup as kernel_warmup
from nomad_tpu_torch.telemetry.histogram import histograms, percentile
from nomad_tpu_torch.telemetry.kernel_profile import profiler
from nomad_tpu_torch.tensors.device_state import (
    DeviceClusterState,
    default_device_state,
)
from nomad_tpu_torch.tensors.schema import (
    MAX_DEV_REQS,
    SPREAD_BUCKETS,
    AskTensor,
    ClusterTensors,
    EvalTensors,
    default_incremental_cluster_cache,
)

SEED = 20261016
B_WAVE = 32          # members per wave (the default worker batch size)
K_PLACE = 10         # placements per eval (n_steps)
K_STEPS = 16         # the eval's step bucket, pad_steps(K_PLACE): T = 512
MAIN_ROUNDS = 64     # rounds of each eval thread; waves at least as many
ATOL = 1e-5          # scores, top-k scores and carries: kernel vs plain
NEAR_TIE = 1e-5      # a differing choice is excused only below this gap
HBM_BYTES_S = 3.35e12            # H100 SXM device memory rate
F32_OPS_S = 67e12                # H100 SXM f32 rate outside tensor cores
#: f32 operations of one (member, node) score: used + carry (3), fit
#: subtractions and compares (6), utilization adds (2), two divides and
#: two pow for the free fractions, the fit sum, clamps and select (6),
#: normalisation (anti-affinity, penalty, affinity planes and the final
#: divide: 6), and the mask (2)
OPS_PER_NODE_SCORE = 25
#: per (active step, node): the argmax compare and the top-8 compares
OPS_PER_NODE_SELECT = 3
#: per (member, node) for the pre-wave metrics pass
OPS_PER_NODE_METRIC = 10


def bound(nbytes: int, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of the byte time at HBM_BYTES_S
    and the operation time at F32_OPS_S."""
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / F32_OPS_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")

VARIANTS = ("lean", "shuffle", "penalty_preferred", "distinct", "ports",
            "kitchen_sink")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


#: the variants that carry the kitchen sink's planes ("everything" adds a
#: spread stanza, a device ask, a core ask and a bandwidth ask)
SINK = ("kitchen_sink", "everything")


def variant_features(variant: str):
    f = LEAN_FEATURES._replace(with_topk=True)
    if variant in ("shuffle", "penalty_preferred") + SINK:
        f = f._replace(with_shuffle=True)
    if variant in ("penalty_preferred",) + SINK:
        f = f._replace(with_step_penalties=True, with_preferred=True)
    if variant in ("distinct",) + SINK:
        f = f._replace(with_distinct=True)
    if variant in ("ports",) + SINK:
        f = f._replace(with_ports=True)
    if variant == "everything":
        f = f._replace(n_spreads=1)
    if variant in ("devices", "everything"):
        f = f._replace(with_devices=True)
    if variant in ("cores", "everything"):
        f = f._replace(with_cores=True)
    if variant in ("network", "everything"):
        f = f._replace(with_network=True)
    return f


def base_kin(cluster, used):
    """One eval's KernelIn over the cluster whose wave-shared planes (the
    cluster's, the resident usage, the neutral singletons) every member
    holds by identity."""
    neutral = neutral_planes(cluster.n_pad)
    ev = EvalTensors(
        base_mask=cluster.ready, used_cpu=used[0], used_mem=used[1],
        used_disk=used[2], used_mbits=neutral.zeros_i32,
        avail_mbits=cluster.avail_mbits, used_cores=neutral.zeros_i32,
        port_conflict_words=None, free_dyn_delta=neutral.zeros_i32,
        dev_free=neutral.zeros_dev, dev_aff_score=neutral.zeros_f32,
        has_dev_affinity=False, job_tg_count=neutral.zeros_i32,
        job_any_count=neutral.zeros_i32, distinct_hosts_job=False,
        distinct_hosts_tg=False, penalty=neutral.zeros_bool,
        aff_score=neutral.zeros_f32, has_affinities=False, spreads=[],
        ask=AskTensor(cpu=500.0, mem=256.0, disk=150.0, reserved_ports=[],
                      dev_counts=np.zeros(MAX_DEV_REQS, np.int32)),
        desired_count=K_PLACE)
    return build_kernel_in(cluster, ev, K_PLACE)


def make_member(base, cluster, variant: str, rng):
    """One member of ``variant``: a C2M job shape's ask plus the
    variant's per-member planes."""
    n, n_pad = cluster.n_real, cluster.n_pad
    shape = rng.choice(len(C2M_SHAPE_CPU), p=C2M_SHAPE_P / C2M_SHAPE_P.sum())
    kin = base._replace(
        ask_cpu=np.asarray(C2M_SHAPE_CPU[shape], np.float32),
        ask_mem=np.asarray(C2M_SHAPE_MEM[shape], np.float32),
        desired_count=np.asarray(int(rng.integers(K_PLACE, 4 * K_PLACE)),
                                 np.int32))
    f = variant_features(variant)
    if f.with_shuffle:
        kin = kin._replace(node_perm=rng.permutation(n_pad).astype(np.int32))
    if f.with_step_penalties:
        kp = pad_steps(K_PLACE)
        pen = np.full((kp, MAX_PENALTY_NODES), -1, np.int32)
        pen[:3, 0] = rng.integers(0, n, 3)
        pref = np.full(kp, -1, np.int32)
        pref[int(rng.integers(0, K_PLACE))] = rng.integers(0, n)
        kin = kin._replace(step_penalty=pen, step_preferred=pref)
    if f.with_ports:
        kin = kin._replace(
            port_conflict=rng.random(n_pad) < 0.3,
            ask_has_reserved_ports=np.asarray(True),
            ask_dyn_ports=np.asarray(2, np.int32))
    if f.with_distinct:
        kin = kin._replace(
            job_tg_count=rng.integers(0, 2, n_pad).astype(np.int32),
            job_any_count=rng.integers(0, 3, n_pad).astype(np.int32),
            distinct_hosts_job=np.asarray(variant in SINK),
            distinct_hosts_tg=np.asarray(True))
    if f.n_spreads:
        kin = rack_stanza(kin, cluster, rng)
    if f.with_devices:
        # two device kinds asked, 0-2 instances of each free on a node
        dev_free = np.zeros((n_pad, MAX_DEV_REQS), np.float32)
        dev_free[:n] = rng.integers(0, 3, (n, MAX_DEV_REQS))
        kin = kin._replace(
            dev_free=dev_free, ask_dev=np.asarray([1, 0, 1, 0], np.float32),
            has_dev_affinity=np.asarray(True),
            dev_aff_score=(rng.random(n_pad) * 0.5).astype(np.float32))
    if f.with_cores:
        used_cores = np.zeros(n_pad, np.int32)
        used_cores[:n] = rng.integers(0, 3, n)
        kin = kin._replace(used_cores=used_cores,
                           ask_cores=np.asarray(1, np.int32))
    if f.with_network:
        used_mbits = np.zeros(n_pad, np.int32)
        used_mbits[:n] = rng.integers(0, 900, n)
        kin = kin._replace(used_mbits=used_mbits,
                           ask_mbits=np.asarray(100, np.int32))
    return kin, f


def rack_buckets(cluster) -> np.ndarray:
    """Each node's rack as its spread bucket (-1 on the padding)."""
    racks = np.full(cluster.n_pad, -1, np.int32)
    racks[:cluster.n_real] = [int(c.split("-")[1]) % SPREAD_BUCKETS
                              for c in cluster.computed_classes]
    return racks


def rack_stanza(kin, cluster, rng):
    """One spread stanza over the rack attribute with counts already
    placed (0-3 a rack): even, or (half the time) desired counts."""
    s = kin.spread_active.shape[0]
    active = np.zeros(s, bool)
    active[0] = True
    bucket = np.full((s, cluster.n_pad), -1, np.int32)
    bucket[0] = rack_buckets(cluster)
    counts = np.zeros((s, SPREAD_BUCKETS), np.float32)
    counts[0] = rng.integers(0, 4, SPREAD_BUCKETS)
    desired = np.full((s, SPREAD_BUCKETS), -1.0, np.float32)
    even = active.copy()
    if rng.random() < 0.5:
        even[0] = False
        desired[0] = rng.integers(1, 6, SPREAD_BUCKETS)
    return kin._replace(
        spread_active=active, spread_even=even,
        spread_weight=active.astype(np.float32), spread_bucket=bucket,
        spread_counts=counts, spread_desired=desired)


def spread_member(base, cluster):
    """A member with one even-spread stanza over the rack attribute."""
    racks = rack_buckets(cluster)
    s = base.spread_active.shape[0]
    active = np.zeros(s, bool)
    active[0] = True
    bucket = np.full((s, cluster.n_pad), -1, np.int32)
    bucket[0] = racks
    kin = base._replace(
        spread_active=active, spread_even=active.copy(),
        spread_weight=active.astype(np.float32), spread_bucket=bucket,
        spread_counts=np.zeros((s, SPREAD_BUCKETS), np.float32),
        spread_desired=np.full((s, SPREAD_BUCKETS), -1.0, np.float32))
    return kin, variant_features("shuffle")._replace(n_spreads=1)


def wave_of(base, cluster, variant: str, rng, dev):
    members = [make_member(base, cluster, variant, rng)
               for _ in range(B_WAVE)]
    return coalesce.assemble_wave([m[0] for m in members],
                                  [K_STEPS] * B_WAVE,
                                  [m[1] for m in members], dev)


def compare(got, want, wave, ctx: str) -> dict:
    """Kernel against plain on one wave. Exact: choices, found, top-k
    indices, metrics; scores, top-k scores and carries within ATOL. The
    first differing step is excused only as a near-tie (the plain
    version's values at the differing top-k position within NEAR_TIE);
    the wave's later steps then run on other carries and are not
    compared."""
    t, b = wave.t_pad, wave.b_pad
    g = unpack_fused_wave(got.packed.cpu().numpy(), t, b)
    w = unpack_fused_wave(want.packed.cpu().numpy(), t, b)
    for name in FUSED_METRIC_FIELDS:
        check(np.array_equal(g[name], w[name]), f"{ctx}: {name} differs")
    gi, wi = got.topk_idx.cpu().numpy(), want.topk_idx.cpu().numpy()
    gs, ws = got.topk_scores.cpu().numpy(), want.topk_scores.cpu().numpy()
    differs = (g["chosen"] != w["chosen"]) | (g["found"] != w["found"]) \
        | np.any(gi != wi, axis=1)
    bad = np.nonzero(differs)[0]
    near_ties = 0
    upto = t
    if len(bad):
        s = int(bad[0])
        q = int(np.nonzero(gi[s] != wi[s])[0][0]) if np.any(
            gi[s] != wi[s]) else 0
        row = ws[s]
        gaps = [abs(row[q] - row[q + 1])] if q + 1 < len(row) else []
        if q > 0:
            gaps.append(abs(row[q - 1] - row[q]))
        check(min(gaps) < NEAR_TIE,
              f"{ctx}: step {s} differs at top-k slot {q} and is no "
              f"near-tie (plain values {row.tolist()})")
        near_ties, upto = 1, s
    errs = [np.abs(g["scores"][:upto] - w["scores"][:upto]).max(initial=0.0),
            np.abs(gs[:upto] - ws[:upto]).max(initial=0.0)]
    if not len(bad):
        for name in ("a_cpu", "a_mem", "a_disk"):
            errs.append(float((getattr(got, name)
                               - getattr(want, name)).abs().max()))
    err = float(max(errs))
    check(err <= ATOL, f"{ctx}: max abs error {err} > {ATOL}")
    return {"ctx": ctx, "near_ties": near_ties,
            "steps_not_compared": t - upto, "max_abs_err": err,
            "placed": int(g["found"].sum()),
            "active_steps": active_steps(wave)}


def active_steps(wave) -> int:
    """Steps that place for a real member (the rest are padding)."""
    sm = wave.step_member.cpu().numpy()
    n_steps = wave.kin.n_steps.cpu().numpy()
    ok = sm >= 0
    return int(np.sum(ok & (wave.step_local.cpu().numpy()
                            < n_steps[np.clip(sm, 0, None)])))


def capacity_ok(cluster, resident, ctx: str) -> None:
    for plane, cap in (("used_cpu", cluster.cap_cpu),
                       ("used_mem", cluster.cap_mem),
                       ("used_disk", cluster.cap_disk)):
        used = getattr(resident, plane).cpu().numpy()
        over = int(np.sum(used > cap + 1e-3))
        check(over == 0, f"{ctx}: {over} nodes over capacity in {plane}")


def wave_ops(wave) -> int:
    """f32 operations the fused wave needs: a step changes only the
    chosen node's carries, so each member with a step scores every node
    once; each active step then selects over every node (argmax and
    top-8 compares) and rescores the chosen node and its penalty nodes;
    plus the metrics pass over every (member, node)."""
    n = wave.kin.cap_cpu.shape[-1]
    sm = wave.step_member.cpu().numpy()
    members = len(np.unique(sm[sm >= 0]))
    active = active_steps(wave)
    return (members * n * OPS_PER_NODE_SCORE
            + active * (n * OPS_PER_NODE_SELECT
                        + (1 + MAX_PENALTY_NODES) * OPS_PER_NODE_SCORE)
            + wave.b_pad * n * OPS_PER_NODE_METRIC)


def wave_bytes(wave, out) -> int:
    """Bytes the fused wave must move: each input leaf the kernel reads
    once (shared leaves once, stacked ones per member), the step maps,
    and each output written once."""
    total = wave.step_member.nbytes + wave.step_local.nbytes
    for name, _ in ck._LEAVES:
        total += getattr(wave.kin, name).nbytes
    return total + sum(x.nbytes for x in out)


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if sys.argv[1:2] == ["--warm-start"]:
        return warm_start_alone(sys.argv[2:])
    if sys.argv[1:2] == ["--raft-cluster"]:
        return raft_cluster_child(*sys.argv[2:4])
    if sys.argv[1:2] == ["--client-phase"]:
        return client_phase_alone(sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-phase"]:
        return mesh_phase_alone(sys.argv[2:])
    if sys.argv[1:2] == ["--place-batch-phase"]:
        return place_batch_alone(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "smoke run needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    record: dict = {}
    t_start = time.perf_counter()

    # ---- 1. card and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    t0 = time.perf_counter()
    builds = ck.load_libraries()
    record["build_s"] = time.perf_counter() - t0
    ptxas = [ln.strip() for b in builds.values() for ln in b.log.splitlines()
             if any(k in ln for k in ("registers", "spill", "smem",
                                      "Compiling entry"))]
    for ln in ptxas:
        log(f"ptxas: {ln}")
    record["ptxas"] = ptxas
    for name, b in builds.items():
        log(f"build: {b.path} (cached={b.cached})")
    log(f"build: {len(builds)} libraries in {record['build_s']:.2f} s")

    seconds = record["phase_seconds"] = {}

    def timed(fn, *args):
        # each phase's wall seconds, so that the run's time against its
        # limit can be read phase by phase
        t0 = time.perf_counter()
        got = fn(*args)
        name = fn.__name__.removeprefix("run_")
        seconds[name] = time.perf_counter() - t0
        log(f"{name}: {seconds[name]:.1f} s")
        return got

    kline = timed(run_phases, dev, record)
    kline["kernels"] += timed(run_batch_phases, dev, record)
    sched, state_bytes = timed(run_sched_phase, dev, record)
    kline["kernels"][0]["sched_launches"] = sched["b1_launches"]
    kline["kernels"].append(candidate_entry(sched["candidate_set"]))
    server = timed(run_server_phase, dev, record, state_bytes)
    timed(run_warm_start_phase, record, state_bytes)
    workerproc = timed(run_workerproc_phase, dev, record, state_bytes,
                       server[-1])
    raft = timed(run_raft_phase, record, state_bytes, smi)
    agent = timed(run_agent_phase, dev, record, state_bytes, server[-1],
                  smi)
    client = timed(run_client_phase, dev, record, state_bytes, smi)
    mesh = timed(run_mesh_phase, dev, record, state_bytes, server[-1],
                 record["warm_start_manifest"])
    del state_bytes
    place_batch = timed(run_place_batch_phase, dev, record)
    kline["kernels"][0]["server_launches"] = sum(
        arm["b1_launches"] for arm in server)
    candidate = next(k for k in kline["kernels"]
                     if k["name"] == "candidate_eval_place")
    candidate["server_batch1_launches"] = record["server_batch1"][
        "candidate_launches"]
    candidate["client_launches"] = client["device_plugin"]["route"][
        "candidate_launches"]
    kline["kernels"][0]["workerproc_launches"] = sum(
        arm["b1_launches"] for arm in workerproc)
    kline["kernels"][0]["raft_launches"] = raft["b1_launches"]
    kline["kernels"][0]["agent_launches"] = agent["agent_launches"]
    kline["kernels"][0]["client_launches"] = client["client_launches"]
    kline["kernels"][0]["mesh_launches"] = mesh["b1_launches"]
    kline["kernels"][0]["place_batch_launches"] = \
        place_batch["launches"]["b1"]
    joint = next(k for k in kline["kernels"]
                 if k["name"] == "joint_wave_place")
    joint["client_launches"] = client["device_plugin"]["route"][
        "joint_launches"]
    joint["place_batch_launches"] = place_batch["launches"]["joint"]
    kline["kernels"].append(mesh["kernel_entry"])
    kline["kernels"][-1]["place_batch_launches"] = \
        place_batch["launches"]["kernel"]
    kline["kernels"].append(mesh["joint_kernel_entry"])
    kline["kernels"][-1]["place_batch_launches"] = \
        place_batch["launches"]["joint_sharded"]
    record["card"] = smi
    record["total_s"] = time.perf_counter() - t_start
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"total: {record['total_s']:.1f} s")

    print(json.dumps(kline))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_phases(dev: torch.device, record: dict) -> dict:
    """Phases 2-6 on ``dev``; returns the kernels' JSON line."""
    # ---- 2. kernel against plain at the live shape ----
    rng = np.random.default_rng(SEED)
    cluster = c2m_cluster(10_000, seed=SEED)
    ucpu, umem, udisk, clipped = c2m_pack_usage(cluster, 100_000, seed=SEED)
    log(f"cluster: {cluster.n_real} nodes, N={cluster.n_pad}, "
        f"100000 allocs, {clipped} nodes clipped at 90%")
    base = base_kin(cluster, (ucpu, umem, udisk))
    live = []
    waves = {}
    for variant in VARIANTS:
        wave = wave_of(base, cluster, variant, rng, dev)
        check(wave.t_pad == 512 and wave.kin.cap_cpu.dim() == 1,
              f"{variant}: unexpected wave layout")
        got = ck.fused_wave_place(wave.kin, wave.step_member,
                                  wave.step_local, wave.t_pad,
                                  wave.features)
        want = ck.fused_wave_place_reference(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features)
        torch.cuda.synchronize()
        res = compare(got, want, wave, f"live/{variant}")
        log(f"live {variant}: {json.dumps(res)}")
        check(res["placed"] > 0, f"live/{variant}: nothing placed")
        live.append(res)
        waves[variant] = wave
    live_steps = sum(r["active_steps"] for r in live)
    live_ties = sum(r["near_ties"] for r in live)
    log(f"live near-ties: {live_ties} of {live_steps} active steps")
    record["live"] = live

    # ---- 3. the main path: coalesced waves into resident usage ----
    resident = coalesce.ResidentUsage(ucpu, umem, udisk, device=dev)
    init = [x.copy() for x in (ucpu, umem, udisk)]
    co = coalesce.LaunchCoalescer(B_WAVE, device=dev, resident=resident)
    placed = [[] for _ in range(B_WAVE)]
    prep_s = [0.0] * B_WAVE       # host seconds building members, per thread
    launch_s = [0.0] * B_WAVE     # host seconds inside co.launch, per thread
    errors: list = []
    mix = ("shuffle",) * 6 + ("ports", "ports", "penalty_preferred",
                              "distinct")

    # 32 member builds on this thread alone: what one round's preparation
    # costs when the builds cannot overlap
    srng = np.random.default_rng(SEED + 999)
    t0 = time.perf_counter()
    for r in range(B_WAVE):
        make_member(base, cluster, mix[r % len(mix)], srng)
    serial_prep_s = time.perf_counter() - t0

    def evaluator(tid: int) -> None:
        trng = np.random.default_rng(SEED + 1000 + tid)
        try:
            for r in range(MAIN_ROUNDS):
                variant = mix[(tid + r) % len(mix)]
                t_a = time.perf_counter()
                kin, f = make_member(base, cluster, variant, trng)
                t_b = time.perf_counter()
                out = co.launch(kin, K_STEPS, f)
                t_c = time.perf_counter()
                prep_s[tid] += t_b - t_a
                launch_s[tid] += t_c - t_b
                if len(out.chosen) != K_STEPS:
                    errors.append(f"thread {tid}: slice of "
                                  f"{len(out.chosen)} steps")
                rows = np.asarray(out.chosen)[np.asarray(out.found)]
                placed[tid].append((rows, float(kin.ask_cpu),
                                    float(kin.ask_mem),
                                    float(kin.ask_disk)))
        except Exception as e:      # noqa: BLE001 - checked after join
            errors.append(f"thread {tid}: {e!r}")
        finally:
            co.done()

    ck.launches = 0
    coalesce.fused_wave_stats.reset()
    coalesce.wave_stats.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=evaluator, args=(i,))
               for i in range(B_WAVE)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = ck.launches
    check(not any(th.is_alive() for th in threads), "main path hung")
    check(not errors, f"main path errors: {errors[:3]}")
    fstats = coalesce.fused_wave_stats.snapshot()
    wstats = coalesce.wave_stats.snapshot()
    check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
          f"composite fallbacks or failed waves: {fstats}")
    check(main_launches == fstats["launches"] == co.launches,
          f"kernel launches {main_launches} != fused waves {fstats} / "
          f"coalescer waves {co.launches}")
    check(co.launches >= MAIN_ROUNDS, f"only {co.launches} waves")
    check(main_launches > 0, "the main path never launched the kernel")
    capacity_ok(cluster, resident, "main path")
    # every member got its own slice: replaying each member's own
    # placements with its own ask reproduces the committed usage
    want = [x.astype(np.float64) for x in init]
    n_placed = 0
    for rows_list in placed:
        for rows, ac, am, ad in rows_list:
            check(np.all((rows >= 0) & (rows < cluster.n_real)),
                  "placement outside the real nodes")
            np.add.at(want[0], rows, ac)
            np.add.at(want[1], rows, am)
            np.add.at(want[2], rows, ad)
            n_placed += len(rows)
    for plane, w in zip(("used_cpu", "used_mem", "used_disk"), want):
        got = getattr(resident, plane).cpu().numpy()
        err = float(np.abs(got - w).max())
        check(err <= 1e-2, f"main path: {plane} differs from the members' "
              f"own placements by {err}")
    check(n_placed > 0, "main path placed nothing")
    evals = B_WAVE * MAIN_ROUNDS
    main = {"waves": co.launches, "kernel_launches": main_launches,
            "fallbacks": fstats["fallbacks"], "evals": evals,
            "placements": n_placed, "wall_s": wall,
            "evals_per_s": evals / wall,
            "round_ms": wall * 1e3 / MAIN_ROUNDS,
            "member_prep_ms_per_round": float(np.mean(prep_s)) * 1e3
            / MAIN_ROUNDS,
            "launch_ms_per_round": float(np.mean(launch_s)) * 1e3
            / MAIN_ROUNDS,
            "serial_32_member_builds_ms": serial_prep_s * 1e3,
            "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
            "wave_latency_p99_ms": wstats["wave_latency_p99_ms"],
            "park_latency_p50_ms": wstats["park_latency_p50_ms"],
            "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
            "assemble_latency_p99_ms": wstats["assemble_latency_p99_ms"],
            "fill_ratio": wstats["fill_ratio"],
            "deadline_launches": wstats["deadline_launches"]}
    log(f"main path: {json.dumps(main)}")
    record["main"] = main

    # ---- 4. the composite on the card: the joint kernel ----
    joint = run_joint_phase(dev, record, base, cluster, resident, rng)

    # ---- 5. scale: 100k nodes, 1M allocs ----
    big = c2m_cluster(100_000, seed=SEED + 1)
    bc, bm, bd, bclip = c2m_pack_usage(big, 1_000_000, seed=SEED + 1)
    bbase = base_kin(big, (bc, bm, bd))
    scale = []
    for variant in ("shuffle", "kitchen_sink"):
        wave = wave_of(bbase, big, variant, rng, dev)
        check(wave.kin.cap_cpu.shape[-1] == 131072, "scale N")
        got = ck.fused_wave_place(wave.kin, wave.step_member,
                                  wave.step_local, wave.t_pad, wave.features)
        want = ck.fused_wave_place_reference(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features)
        torch.cuda.synchronize()
        res = compare(got, want, wave, f"scale/{variant}")
        log(f"scale {variant}: {json.dumps(res)}")
        scale.append(res)
        ms_big = cuda_ms(lambda: ck.fused_wave_place(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features), 3)
        res["ms"] = ms_big
    record["scale"] = {"nodes": 100_000, "n_pad": big.n_pad,
                       "allocs": 1_000_000, "clipped": bclip,
                       "waves": scale}
    record["composite"]["scale"] = joint_scale = [
        joint_wave_check(*joint_wave(bbase, big, union, rng, dev),
                         f"composite scale/{union}", reps=3)
        for union in JOINT_SCALE_UNIONS]
    for res in joint_scale:
        log(f"composite scale {res['union']}: {json.dumps(res)}")
    ties = live_ties + sum(r["near_ties"] for r in scale)
    steps = live_steps + sum(r["active_steps"] for r in scale)
    log(f"near-ties: {ties} of {steps} active steps")
    check(ties <= 0.01 * steps, f"near-ties {ties} > 1% of {steps} steps")

    # ---- 6. times at the live shape (the main path's wave union) ----
    wave = waves["kitchen_sink"]

    def kernel():
        return ck.fused_wave_place(wave.kin, wave.step_member,
                                   wave.step_local, wave.t_pad,
                                   wave.features)

    def plain():
        return ck.fused_wave_place_reference(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features)

    for _ in range(3):
        out = kernel()
    kernel_ms = cuda_ms(kernel, 20)
    plain()
    plain_ms = cuda_ms(plain, 2)
    n = wave.kin.cap_cpu.shape[-1]
    active = active_steps(wave)
    nbytes = wave_bytes(wave, out)
    ops = wave_ops(wave)
    bound_ms, bound_by = bound(nbytes, ops)
    max_err = max(r["max_abs_err"] for r in live + scale)
    cluster_ctas = ck.fused_wave_cluster_size()
    us_per_step = kernel_ms * 1e3 / active
    log(f"b1: {kernel_ms:.4f} ms per live wave, {us_per_step:.3f} us per "
        f"active step ({active} active of {wave.t_pad}), cluster of "
        f"{cluster_ctas} CTAs; scale waves "
        f"{[round(r['ms'], 4) for r in scale]} ms")
    kline = {"kernels": [{
        "name": "fused_wave_place",
        "route": "cuda",
        "source": "nomad_tpu_torch/csrc/fused_wave.cu",
        "replaces": "nomad_tpu/ops/pallas_kernel.py:600",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "cluster": cluster_ctas,
    }, joint_entry(joint, joint_scale)]}
    record["times"] = {"bytes": nbytes, "ops": ops, "active_steps": active,
                       "us_per_active_step": us_per_step,
                       "cluster": cluster_ctas,
                       "n": n, "b": wave.b_pad, "t": wave.t_pad}
    record["kernels"] = kline["kernels"]
    return kline


# ---------------------------------------------------------------------------
# Phase 4: the joint kernel, for the waves outside B1's envelope.
# ---------------------------------------------------------------------------

#: one wave a feature union outside B1's envelope: a spread member among
#: 31 shuffle members, all 32 asking devices, cores or bandwidth, and all
#: 32 asking everything at once with the kitchen sink's planes
JOINT_UNIONS = ("spread", "devices", "cores", "network", "everything")
JOINT_SCALE_UNIONS = ("spread", "everything")
#: f32 operations a node a step re-derives under a spread stanza: the
#: bucket lookup and add of each active stanza, the spread-on test, the
#: count and the sum, the divide, and the argmax compare
OPS_PER_NODE_SPREAD = 6


def joint_wave(base, cluster, union: str, rng, dev) -> tuple:
    """``(kins, features, wave, union)``: a wave of ``union`` (see
    JOINT_UNIONS) assembled on ``dev``."""
    if union == "spread":
        members = [spread_member(base, cluster)] + [
            make_member(base, cluster, "shuffle", rng)
            for _ in range(B_WAVE - 1)]
    else:
        members = [make_member(base, cluster, union, rng)
                   for _ in range(B_WAVE)]
    kins, feats = [m[0] for m in members], [m[1] for m in members]
    wave = coalesce.assemble_wave(kins, [K_STEPS] * B_WAVE, feats, dev)
    return kins, feats, wave, union


def spread_steps(wave) -> int:
    """Active steps of members with an active spread stanza: the steps
    whose every node's score the kernel re-derives."""
    sm = wave.step_member.cpu().numpy()
    spread = active_stanzas(wave).any(axis=-1)
    n_steps = wave.kin.n_steps.cpu().numpy()
    ok = sm >= 0
    m = np.clip(sm, 0, None)
    return int(np.sum(ok & (wave.step_local.cpu().numpy() < n_steps[m])
                      & spread[m]))


#: the leaves each feature adds to B1's (``ck._LEAVES``)
JOINT_FEATURE_LEAVES = {
    "with_devices": ("dev_free", "dev_aff_score", "has_dev_affinity",
                     "ask_dev"),
    "with_cores": ("free_cores", "shares_per_core", "used_cores",
                   "ask_cores"),
    "with_network": ("used_mbits", "avail_mbits", "ask_mbits"),
    "n_spreads": ("spread_active", "spread_even", "spread_weight",
                  "spread_bucket", "spread_counts", "spread_desired"),
}


#: spread leaves with a stanza axis second to last: a stanza's row is
#: read only where a member has it active
SPREAD_ROW_LEAVES = ("spread_bucket", "spread_counts", "spread_desired")


def active_stanzas(wave) -> np.ndarray:
    """bool [B, n_spreads]: each member's active spread stanzas."""
    active = wave.kin.spread_active.cpu().numpy().astype(bool)
    if active.ndim == 1:
        active = np.broadcast_to(active, (wave.b_pad,) + active.shape)
    return active[:, :wave.features.n_spreads]


def joint_bound(wave, out) -> tuple:
    """``(bound_ms, bound_by, bytes, ops)`` of a joint wave: each leaf the
    wave's features read, once (B1's planes and the device, core,
    bandwidth and spread planes it asks for, of the spread planes only
    the rows of the stanzas a member has active), the step maps and the
    outputs; B1's operations plus each spread step's pass over every
    node."""
    n = int(wave.kin.cap_cpu.shape[-1])
    active = active_stanzas(wave)
    names = [name for name, _ in ck._LEAVES] + [
        name for feature, leaves in JOINT_FEATURE_LEAVES.items()
        if getattr(wave.features, feature) for name in leaves]

    def leaf_bytes(name):
        x = getattr(wave.kin, name)
        if name not in SPREAD_ROW_LEAVES:
            return x.nbytes
        rows = active.sum() if x.dim() == 3 else active.any(axis=0).sum()
        return int(rows) * x.shape[-1] * x.element_size()

    nbytes = wave.step_member.nbytes + wave.step_local.nbytes + sum(
        leaf_bytes(name) for name in names) + sum(x.nbytes for x in out)
    ops = wave_ops(wave) + spread_steps(wave) * n * OPS_PER_NODE_SPREAD
    ms, by = bound(nbytes, ops)
    return ms, by, nbytes, ops


@contextlib.contextmanager
def forced_clusters(clusters: int):
    """The joint kernel's plan forced to ``clusters`` clusters, laid out
    as the plan lays them out (its rows in shared memory where they fit,
    else its global-row instantiation)."""
    real = ck.joint_clusters
    ck.joint_clusters = (
        lambda n, b, shuffle, ns, limit, most: ck.joint_layout(
            n, b, shuffle, ns, limit, clusters))
    try:
        yield
    finally:
        ck.joint_clusters = real


@contextlib.contextmanager
def forced_sharded_clusters(clusters: int):
    """The joint sharded kernel's plan forced to ``clusters`` clusters a
    card, laid out as the plan lays them out."""
    real = ck.joint_sharded_clusters
    ck.joint_sharded_clusters = (
        lambda rows, b, shuffle, ns, limit, most, n_cards:
        ck.joint_sharded_layout(rows, b, shuffle, ns, limit, clusters,
                                n_cards))
    try:
        yield
    finally:
        ck.joint_sharded_clusters = real


def joint_plan_of(wave, dev: torch.device):
    return ck.joint_plan(dev, int(wave.kin.cap_cpu.shape[-1]), wave.b_pad,
                         wave.features.with_shuffle,
                         wave.features.n_spreads)


def one_cluster_check(kernel, got, wave, ctx: str, reps: int) -> dict:
    """The same wave forced onto one cluster: bit for bit the plan's
    outputs (the error word 0 in both), and its CUDA-event ms."""
    t, b = wave.t_pad, wave.b_pad
    ck.raise_on_wave_error(got.packed.cpu().numpy(), t, b)
    with forced_clusters(1):
        one = kernel()
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(one, f), getattr(got, f))
                   for f in one._fields)
        check(same, f"{ctx}: one cluster's wave differs from the plan's")
        kernel()
        ms = cuda_ms(kernel, reps)
        plan = joint_plan_of(wave, wave.kin.cap_cpu.device)
    return {"one_cluster_ms": ms,
            "one_cluster_us_per_active_step": ms * 1e3 / active_steps(wave),
            "one_cluster_global_rows": plan.global_rows > 0}


def joint_wave_check(kins, feats, wave, union, ctx: str,
                     reps: int = 10) -> dict:
    """The joint kernel against its plain version on one wave (exact:
    max abs error 0.0, no near-tie), then the kernel's CUDA-event ms over
    ``reps`` launches beside the plain version's one call and the bound,
    with the plan's cluster count and where its rows live; then the same
    wave forced onto one cluster (``one_cluster_check``). These launches
    are checks, not the main path."""
    def kernel():
        return ck.joint_wave_place(wave.kin, wave.step_member,
                                   wave.step_local, wave.t_pad,
                                   wave.features)

    want, plain_ms = event_ms(lambda: ck.fused_wave_place_reference(
        wave.kin, wave.step_member, wave.step_local, wave.t_pad,
        wave.features))
    got = kernel()
    torch.cuda.synchronize()
    res = compare(got, want, wave, ctx)
    check(res["max_abs_err"] == 0.0 and res["near_ties"] == 0,
          f"{ctx}: the joint kernel differs from its plain version: {res}")
    check(res["placed"] > 0, f"{ctx}: nothing placed")
    kernel()
    ms = cuda_ms(kernel, reps)
    bound_ms, bound_by, nbytes, ops = joint_bound(wave, got)
    plan = joint_plan_of(wave, wave.kin.cap_cpu.device)
    res.update(union=union, n_pad=int(wave.kin.cap_cpu.shape[-1]), ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, ops=ops, spread_steps=spread_steps(wave),
               us_per_active_step=ms * 1e3 / res["active_steps"],
               clusters=plan.clusters, rows_shared=plan.global_rows == 0,
               **one_cluster_check(kernel, got, wave, ctx, reps))
    return res


def plain_outs(fout, wave) -> list:
    """A FusedWaveOut's member slices, as ``launch_wave`` returns them."""
    host = unpack_fused_wave(fout.packed.cpu().numpy(), wave.t_pad,
                             wave.b_pad)
    ti, ts = fout.topk_idx.cpu().numpy(), fout.topk_scores.cpu().numpy()
    return [KernelOut(
        chosen=host["chosen"][o:o + K_STEPS],
        scores=host["scores"][o:o + K_STEPS],
        found=host["found"][o:o + K_STEPS],
        topk_idx=ti[o:o + K_STEPS], topk_scores=ts[o:o + K_STEPS],
        **{name: host[name][i] for name in FUSED_METRIC_FIELDS})
        for i, o in enumerate(wave.offsets)]


def run_joint_phase(dev: torch.device, record: dict, base, cluster,
                    resident, rng) -> dict:
    """Phase 4: one wave of each union in JOINT_UNIONS through
    ``launch_wave`` into phase 3's resident usage (the main path of the
    joint kernel: its counts set to 0 just before, read just after),
    each held exactly against the plain version on the same inputs (the
    resident planes as the wave reads them); then each wave's kernel
    alone against its plain version, timed."""
    waves = [joint_wave(base, cluster, union, rng, dev)
             for union in JOINT_UNIONS]
    coalesce.fused_wave_stats.reset()
    coalesce.joint_wave_stats.reset()
    b1_before = ck.launches
    ck.joint_launches = 0
    drive = []
    for kins, feats, wave, union in waves:
        ctx = f"composite/{union}"
        want = plain_outs(ck.fused_wave_place_reference(
            wave.kin._replace(used_cpu=resident.used_cpu,
                              used_mem=resident.used_mem,
                              used_disk=resident.used_disk),
            wave.step_member, wave.step_local, wave.t_pad, wave.features),
            wave)
        got, ms = event_ms(lambda: coalesce.launch_wave(
            kins, [K_STEPS] * B_WAVE, feats, device=dev, resident=resident))
        res = compare_waves(got, want, ctx, exact=True)
        check(res["near_ties"] == 0, f"{ctx}: {res}")
        check(res["placed"] > 0, f"{ctx}: nothing placed")
        res.update(union=union, launch_wave_ms=ms)
        drive.append(res)
    launches = ck.joint_launches
    fstats = coalesce.fused_wave_stats.snapshot()
    jstats = coalesce.joint_wave_stats.snapshot()
    n = len(waves)
    check(fstats == {"launches": 0, "fallbacks": n, "failures": 0},
          f"composite: fused wave stats {fstats}")
    check(jstats == {"launches": n, "sharded_launches": 0,
                     "global_rows": 0, "torch_waves": 0}
          and launches == n,
          f"composite: joint stats {jstats}, {launches} kernel launches "
          f"for {n} waves")
    check(ck.launches == b1_before, "composite: a wave launched B1")
    capacity_ok(cluster, resident, "composite")
    checks = [joint_wave_check(kins, feats, wave, union,
                               f"composite kernel/{union}")
              for kins, feats, wave, union in waves]
    for res in drive + checks:
        log(f"composite {res['union']}: {json.dumps(res)}")
    ceiling = run_ceiling_waves(dev, rng)
    joint = {"launches": launches, "fused": fstats, "joint": jstats,
             "drive": drive, "kernel": checks, "ceiling": ceiling}
    record["composite"] = joint
    log(f"composite: {n} waves through launch_wave, {launches} joint "
        f"launches, {fstats['fallbacks']} fallbacks, 0 torch-op waves; "
        + ", ".join(f"{c['union']} {c['ms']:.3f} ms (plain "
                    f"{c['plain_ms']:.1f})" for c in checks))
    return joint


#: phase 4's waves past one cluster's shared memory: a cluster padded to
#: N=524288, a lean union (shuffle: B1 keeps 8 B a node) and everything
CEILING_NODES = 300_000
CEILING_ALLOCS = 1_000_000
CEILING_PAD = 1 << 19
CEILING_UNIONS = ("shuffle", "everything")


def run_ceiling_waves(dev: torch.device, rng) -> list:
    """Phase 4's waves over a node axis padded to N=524288, which B1's
    cluster does not hold in shared memory: each through ``launch_wave``
    (its counts set to 0 just before, read just after: one joint launch
    over the clusters the plan picks, its rows in shared memory, one
    fused fallback, no failure, no B1 launch), exact against the plain
    version; then the kernel alone, timed beside the plain version and
    the bound, and forced onto one cluster: the global-row instantiation,
    bit for bit the same."""
    big = c2m_cluster(CEILING_NODES, seed=SEED + 4)
    uc, um, ud, _ = c2m_pack_usage(big, CEILING_ALLOCS, seed=SEED + 4)
    bbase = base_kin(big, (uc, um, ud))
    check(big.n_pad == CEILING_PAD,
          f"ceiling: N={big.n_pad}, want {CEILING_PAD}")
    out = []
    for union in CEILING_UNIONS:
        kins, feats, wave, _ = joint_wave(bbase, big, union, rng, dev)
        ctx = f"ceiling/{union}"
        shuffle = wave.features.with_shuffle
        plan = joint_plan_of(wave, dev)
        check(not ck.fused_wave_fits(dev, big.n_pad, wave.b_pad, shuffle)
              and plan.clusters > 1 and plan.global_rows == 0,
              f"{ctx}: B1's cluster holds the wave, or the joint plan "
              f"{plan} keeps its rows outside shared memory")
        fout, plain_ms = event_ms(lambda: ck.fused_wave_place_reference(
            wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features))
        want = plain_outs(fout, wave)
        del fout
        coalesce.fused_wave_stats.reset()
        coalesce.joint_wave_stats.reset()
        b0, j0, g0 = ck.launches, ck.joint_launches, ck.joint_global_calls
        got, ms = event_ms(lambda: coalesce.launch_wave(
            kins, [K_STEPS] * B_WAVE, feats, device=dev))
        fstats = coalesce.fused_wave_stats.snapshot()
        jstats = coalesce.joint_wave_stats.snapshot()
        launched = (ck.launches - b0, ck.joint_launches - j0,
                    ck.joint_global_calls - g0)
        check(fstats == {"launches": 0, "fallbacks": 1, "failures": 0}
              and jstats == {"launches": 1, "sharded_launches": 0,
                             "global_rows": 0, "torch_waves": 0}
              and launched == (0, 1, 0),
              f"{ctx}: fused {fstats}, joint {jstats}, B1 / joint / "
              f"global-row launches {launched}")
        res = compare_waves(got, want, ctx, exact=True)
        check(res["near_ties"] == 0 and res["placed"] > 0, f"{ctx}: {res}")
        del got, want

        def kernel():
            return ck.joint_wave_place(wave.kin, wave.step_member,
                                       wave.step_local, wave.t_pad,
                                       wave.features)

        one = kernel()
        kms = cuda_ms(kernel, 3)
        bound_ms, bound_by, nbytes, ops = joint_bound(wave, one)
        res.update(union=union, n_pad=big.n_pad, launch_wave_ms=ms,
                   ms=kms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, ops=ops,
                   us_per_active_step=kms * 1e3 / active_steps(wave),
                   clusters=plan.clusters, rows_shared=True,
                   **one_cluster_check(kernel, one, wave, ctx, 3))
        check(res["one_cluster_global_rows"],
              f"{ctx}: one cluster's wave kept its rows in shared memory")
        log(f"ceiling {union}: {json.dumps(res)}")
        out.append(res)
        del kins, wave, one
    return out


def joint_entry(joint: dict, scale: list) -> dict:
    """The joint kernel's entry in the kernels' JSON line: its launches
    on phase 4's main path, its exactness over every checked wave, and
    the spread wave's times at the live shape (every union's beside)."""
    checks = joint["kernel"]
    spread = next(c for c in checks if c["union"] == "spread")
    return {
        "name": "joint_wave_place",
        "route": "cuda",
        "source": "nomad_tpu_torch/csrc/joint_wave.cu",
        "replaces": "nomad_tpu/ops/kernel.py:1060",
        "launches": joint["launches"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in checks + scale + joint["ceiling"]),
        "ms": spread["ms"],
        "plain_ms": spread["plain_ms"],
        "bound_ms": spread["bound_ms"],
        "bound_by": spread["bound_by"],
        "library_ms": None,
        "cluster": ck.JOINT_CLUSTER,
        # the plan's clusters of JOINT_CLUSTER CTAs, and each wave forced
        # onto one cluster (the layout before the plan spread the rows)
        "clusters": {f"{c['union']}@{c['n_pad']}": c["clusters"]
                     for c in checks + scale + joint["ceiling"]},
        "one_cluster_ms": {f"{c['union']}@{c['n_pad']}": c["one_cluster_ms"]
                           for c in checks + scale + joint["ceiling"]},
        "union_ms": {c["union"]: c["ms"] for c in checks},
        "union_plain_ms": {c["union"]: c["plain_ms"] for c in checks},
        "union_bound_ms": {c["union"]: c["bound_ms"] for c in checks},
        "scale_ms": {c["union"]: c["ms"] for c in scale},
        "scale_plain_ms": {c["union"]: c["plain_ms"] for c in scale},
        "scale_bound_ms": {c["union"]: c["bound_ms"] for c in scale},
        # N=524288 through launch_wave: the plan's clusters (one cluster's
        # global-row instantiation under one_cluster_ms)
        "ceiling_ms": {c["union"]: c["ms"] for c in joint["ceiling"]},
        "ceiling_plain_ms": {c["union"]: c["plain_ms"]
                             for c in joint["ceiling"]},
        "ceiling_bound_ms": {c["union"]: c["bound_ms"]
                             for c in joint["ceiling"]},
        "ceiling_launch_wave_ms": {c["union"]: c["launch_wave_ms"]
                                   for c in joint["ceiling"]},
    }


# ---------------------------------------------------------------------------
# Phases 7-9: the batched schedule-apply path (B3 and B2).
# ---------------------------------------------------------------------------

BATCH_B3 = 512       # bench.py BATCH: the full-width kernel's batch
STEPS_B3 = 4         # kernel-step batches on the B3 path
SCALE_NODES = 100_000   # B3's second width: N=131072
BATCH_B2 = 8192      # bench.py _bench_batch on an accelerator
BATCHES_B2 = 25      # 8192 x 25 evals, the bench's burst
REPLAY_BATCHES = 4
K_CAND = 64          # pallas_topk_place_batch's default candidate count
B2_MEMORY_LIMIT = 64 << 20   # B2's peak allocation over one batch, bytes
#: f32 operations of the lean score of one node: fit compares (6),
#: utilization adds and free fractions (6), two pow, the fit sum, clamps,
#: select and scale (7), anti-affinity (4), plane sums and the final
#: divide (4)
OPS_PER_LEAN_SCORE = 27


def lean_ops(n_steps, k_steps: int, scored: int, width: int) -> int:
    """f32 operations a lean batch placement needs over ``width`` nodes,
    ``scored`` of them in the base mask: a step changes only the chosen
    node's carries, so each eval scores every base node once and tests
    the mask of the rest, then each active step takes one argmax compare
    per base node and rescores the chosen node. A node outside the base
    mask (the padding, or a node no eval may use) needs its mask test
    and nothing more."""
    evals = int((n_steps > 0).sum())
    active = int(np.minimum(n_steps, k_steps).sum())
    return evals * (scored * OPS_PER_LEAN_SCORE + width - scored) + active * (
        scored + OPS_PER_LEAN_SCORE)


def topk_ops(n_steps, k_steps: int, kc: int, scored: int, width: int) -> int:
    """f32 operations B2 needs: per eval every base node scored once and
    compared once for the selection, the mask of every other node tested,
    then each active step one argmax compare per candidate and one
    rescore of the chosen node."""
    evals = int((n_steps > 0).sum())
    active = int(np.minimum(n_steps, k_steps).sum())
    return evals * (scored * (OPS_PER_LEAN_SCORE + 1) + width - scored) + (
        active * (kc + OPS_PER_LEAN_SCORE))


def compare_lean(got, want, n_steps, ctx: str) -> dict:
    """A batch kernel against its plain version: chosen and found exact,
    scores within ATOL. An eval whose choices differ is excused only as a
    near-tie (at its first differing step both picks score within
    NEAR_TIE); its later steps run on other carries and are not
    compared."""
    gc, wc = got[0].cpu().numpy(), want[0].cpu().numpy()
    gs, ws = got[1].cpu().numpy(), want[1].cpu().numpy()
    gf, wf = got[2].cpu().numpy(), want[2].cpu().numpy()
    keep = np.ones(gc.shape, bool)
    near_ties = 0
    for r in np.nonzero(((gc != wc) | (gf != wf)).any(axis=1))[0]:
        s = int(np.nonzero((gc[r] != wc[r]) | (gf[r] != wf[r]))[0][0])
        check(gf[r, s] and wf[r, s] and abs(gs[r, s] - ws[r, s]) < NEAR_TIE,
              f"{ctx}: eval {r} differs at step {s} and is no near-tie "
              f"({gc[r, s]}: {gs[r, s]} vs {wc[r, s]}: {ws[r, s]})")
        near_ties += 1
        keep[r, s:] = False
    err = float(np.abs(gs - ws)[keep].max(initial=0.0))
    check(err <= ATOL, f"{ctx}: max abs error {err} > {ATOL}")
    active = int(np.minimum(n_steps.cpu().numpy(), gc.shape[1]).sum())
    return {"ctx": ctx, "near_ties": near_ties, "active_steps": active,
            "max_abs_err": err, "placed": int(gf.sum())}


def lean_bytes(v: dict, out) -> int:
    """Bytes a batch kernel must move: each lean argument once (the
    shared planes once, not once per eval) and each output once."""
    return sum(x.nbytes for x in v.values()) + sum(x.nbytes for x in out)


def over_capacity(kin, uc, um) -> int:
    """Nodes whose committed cpu or mem exceeds their capacity."""
    return int(np.sum((uc.cpu().numpy() > kin.cap_cpu + 1e-3)
                      | (um.cpu().numpy() > kin.cap_mem + 1e-3)))


def best_of_2(fn) -> tuple:
    """(seconds, result): host clock ending in synchronize, best of 2."""
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), res


def run_batch_phases(dev: torch.device, record: dict) -> list:
    """Phases 7-9 on ``dev``; returns the B3 and B2 kernel entries."""
    # ---- 7. B3: place_batch against plain, then the kernel step ----
    prob = throughput_problem(STEPS_B3, BATCH_B3, seed=7)
    shared = batching.device_put_shared(prob.kin, dev)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    uc0, um0, ns = on(prob.used_cpu), on(prob.used_mem), on(prob.n_steps)
    asks = (on(prob.ask_cpu), on(prob.ask_mem))
    check(shared.cap_cpu.shape[0] == 16384, "throughput N")
    lean = batching._lean_args(shared, uc0, um0, asks[0][0], asks[1][0], ns)
    got = ck.place_batch(*lean, k_steps=K_PLACE)
    want = ck.place_batch_reference(*lean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    b3 = compare_lean(got, want, ns, "b3/place_batch")
    log(f"b3 kernel vs plain: {json.dumps(b3)}")
    check(b3["placed"] > 0, "b3: nothing placed")
    check(b3["near_ties"] <= 0.01 * b3["active_steps"],
          f"b3 near-ties {b3['near_ties']} > 1% of {b3['active_steps']}")
    big = throughput_problem(1, BATCH_B3, n_nodes=SCALE_NODES, seed=8)
    bshared = batching.device_put_shared(big.kin, dev)
    check(bshared.cap_cpu.shape[0] == 131072, "B3 scale N")
    blean = batching._lean_args(bshared, on(big.used_cpu), on(big.used_mem),
                                on(big.ask_cpu[0]), on(big.ask_mem[0]),
                                on(big.n_steps))
    bgot = ck.place_batch(*blean, k_steps=K_PLACE)
    bwant = ck.place_batch_reference(*blean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    b3_big = compare_lean(bgot, bwant, on(big.n_steps), "b3/n131072")
    check(b3_big["placed"] > 0, "b3 scale: nothing placed")
    check(b3_big["near_ties"] <= 0.01 * b3_big["active_steps"],
          f"b3 scale near-ties {b3_big['near_ties']}")
    b3_big["ms"] = cuda_ms(lambda: ck.place_batch(*blean, k_steps=K_PLACE),
                           5)
    log(f"b3 at N=131072: {json.dumps(b3_big)}")
    del bshared, blean, bgot, bwant

    kstep = batching.make_schedule_apply_step_kernel(K_PLACE)
    pstep = batching.make_schedule_apply_step(K_PLACE, LEAN_FEATURES)
    ku, km = pu, pm = uc0, um0
    kstep(shared, ku, km, asks[0][0], asks[1][0], ns)   # first-call costs
    ck.place_batch_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(STEPS_B3):
        out, ku, km = kstep(shared, ku, km, asks[0][t], asks[1][t], ns)
    torch.cuda.synchronize()
    kstep_s = time.perf_counter() - t0
    b3_launches = ck.place_batch_launches
    check(b3_launches == STEPS_B3,
          f"b3 path: {b3_launches} kernel launches for {STEPS_B3} steps")
    for t in range(STEPS_B3):
        _, pu, pm = pstep(shared, pu, pm, asks[0][t], asks[1][t], ns)
    plane_err = max(float((ku - pu).abs().max()), float((km - pm).abs().max()))
    check(plane_err <= 1e-2, f"b3 path: committed planes differ by "
          f"{plane_err}")
    check(torch.equal(uc0, on(prob.used_cpu)), "b3 path wrote its input")
    b3.update(steps=STEPS_B3, launches=b3_launches, plane_err=plane_err,
              step_s=kstep_s / STEPS_B3,
              over_capacity=over_capacity(prob.kin, ku, km),
              n131072=b3_big)
    log(f"b3 path: {json.dumps(b3)}")
    record["b3"] = b3

    v3 = ck._lean_inputs(lean, K_PLACE)
    for _ in range(3):
        ck.place_batch(*lean, k_steps=K_PLACE)
    b3_ms = cuda_ms(lambda: ck.place_batch(*lean, k_steps=K_PLACE), 20)
    b3_plain_ms = cuda_ms(
        lambda: ck.place_batch_reference(*lean, k_steps=K_PLACE), 3)
    b3_bound, b3_by = bound(
        lean_bytes(v3, got),
        lean_ops(prob.n_steps, K_PLACE, int(v3["base_mask"].sum()),
                 v3["cap_cpu"].shape[0]))

    # ---- 8. B2 and the loop at the bench shape ----
    prob = throughput_problem(BATCHES_B2, BATCH_B2, seed=7)
    ns = on(prob.n_steps)
    asks = (on(prob.ask_cpu), on(prob.ask_mem))
    lean = batching._lean_args(shared, uc0, um0, asks[0][0], asks[1][0], ns)
    ck.topk_place_batch(*lean, k_steps=K_PLACE)      # first-call costs
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = ck.topk_place_batch(*lean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    log(f"b2 peak allocation over one batch: {peak} B above {base_mem} B")
    check(peak <= B2_MEMORY_LIMIT,
          f"b2: {peak} B allocated over one batch > {B2_MEMORY_LIMIT}")
    want = ck.topk_place_batch_reference(*lean, k_steps=K_PLACE)
    torch.cuda.synchronize()
    for name, g, w in zip(("chosen", "found", "valid"),
                          (got[0], got[2], got[3]), (want[0], want[2], want[3])):
        check(torch.equal(g, w), f"b2/topk_place_batch: {name} differs")
    b2_err = float((got[1] - want[1]).abs().max())
    check(b2_err <= ATOL, f"b2: max abs error {b2_err} > {ATOL}")
    b2 = {"max_abs_err": b2_err, "invalid": int((~got[3]).sum()),
          "placed": int(got[2].sum()), "peak_alloc_bytes": peak}
    log(f"b2 kernel vs plain: {json.dumps(b2)}")

    kloop = batching.make_schedule_apply_loop(
        K_PLACE, LEAN_FEATURES, topk=True, backend="kernel_topk")
    tloop = batching.make_schedule_apply_loop(K_PLACE, LEAN_FEATURES,
                                              topk=True)
    ck.topk_place_batch_launches = 0
    k_s, kres = best_of_2(lambda: kloop(shared, uc0, um0, *asks, ns))
    b2_launches = ck.topk_place_batch_launches
    check(b2_launches == 2 * BATCHES_B2,
          f"b2 path: {b2_launches} kernel launches for the 2 x {BATCHES_B2} "
          "batches run")
    t_s, tres = best_of_2(lambda: tloop(shared, uc0, um0, *asks, ns))
    loop = compare_loops(kres, tres, prob.kin, "loop")
    evals = BATCH_B2 * BATCHES_B2
    loop.update(batches=BATCHES_B2, runs=2, evals=evals,
                launches=b2_launches,
                kernel_topk_s=k_s, torch_s=t_s,
                kernel_topk_evals_per_s=evals / k_s,
                torch_evals_per_s=evals / t_s)
    log(f"loop: {json.dumps(loop)}")
    record["b2"] = {**b2, "loop": loop}

    v2 = ck._lean_inputs(lean, K_PLACE)
    for _ in range(3):
        out = ck.topk_place_batch(*lean, k_steps=K_PLACE)
    b2_ms = cuda_ms(lambda: ck.topk_place_batch(*lean, k_steps=K_PLACE), 20)
    b2_plain_ms = cuda_ms(
        lambda: ck.topk_place_batch_reference(*lean, k_steps=K_PLACE), 3)
    commit_ms = cuda_ms(lambda: batching.commit_placements(
        uc0, um0, out[0], out[2], asks[0][0], asks[1][0]), 20)
    b2_bound, b2_by = bound(
        lean_bytes(v2, out),
        topk_ops(prob.n_steps, K_PLACE, K_CAND, int(v2["base_mask"].sum()),
                 v2["cap_cpu"].shape[0]))
    batch_ms = k_s / BATCHES_B2 * 1e3
    split = {"kernel_ms": b2_ms, "commit_ms": commit_ms,
             "batch_ms": batch_ms,
             "rest_of_batch_ms": batch_ms - b2_ms - commit_ms,
             "fallback_rows": loop["fallback_kernel_topk"]}
    log(f"b2 batch split: {json.dumps(split)}")
    record["b2"]["split"] = split

    # ---- 9. the replay form: reset_every=1 on a C2M cluster ----
    c2m = c2m_cluster(10_000, seed=SEED)
    ucpu, umem, udisk, _ = c2m_pack_usage(c2m, 100_000, seed=SEED)
    rkin = synthetic_kin_for(c2m, udisk)
    rshared = batching.device_put_shared(rkin, dev)
    rng = np.random.default_rng(SEED + 9)
    shapes = rng.choice(len(C2M_SHAPE_CPU), (REPLAY_BATCHES, BATCH_B2),
                        p=C2M_SHAPE_P / C2M_SHAPE_P.sum())
    rasks = (on(C2M_SHAPE_CPU[shapes]), on(C2M_SHAPE_MEM[shapes]))
    rloop = batching.make_schedule_apply_loop(
        K_PLACE, LEAN_FEATURES, topk=True, backend="kernel_topk",
        reset_every=1)
    ck.topk_place_batch_launches = 0
    r_s, rres = best_of_2(lambda: rloop(rshared, on(ucpu), on(umem), *rasks,
                                        ns))
    check(ck.topk_place_batch_launches == 2 * REPLAY_BATCHES,
          f"replay: {ck.topk_place_batch_launches} kernel launches")
    tres = batching.make_schedule_apply_loop(
        K_PLACE, LEAN_FEATURES, topk=True, reset_every=1)(
        rshared, on(ucpu), on(umem), *rasks, ns)
    replay = compare_loops(rres, tres, rkin, "replay")
    check(replay["placed"] > 0, "replay placed nothing")
    evals = BATCH_B2 * REPLAY_BATCHES
    replay.update(batches=REPLAY_BATCHES, evals=evals,
                  evals_per_s=evals / r_s)
    log(f"replay: {json.dumps(replay)}")
    record["replay"] = replay

    return [
        {"name": "place_batch", "route": "cuda",
         "source": "nomad_tpu_torch/csrc/place_batch.cu",
         "replaces": "nomad_tpu/ops/pallas_kernel.py:218",
         "launches": b3_launches, "max_abs_err": b3["max_abs_err"],
         "ms": b3_ms, "plain_ms": b3_plain_ms, "bound_ms": b3_bound,
         "bound_by": b3_by, "library_ms": None},
        {"name": "topk_place_batch", "route": "cuda",
         "source": "nomad_tpu_torch/csrc/topk_place_batch.cu",
         "replaces": "nomad_tpu/ops/pallas_kernel.py:377",
         "launches": b2_launches, "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None},
    ]


def synthetic_kin_for(cluster, used_disk):
    """The replay's shared planes (bench.py ``run_replay``): one lean
    eval over ``cluster`` with the resident disk usage and 150 MB disk
    asks."""
    ev = synthetic_eval(cluster, desired_count=K_PLACE)
    kin = build_kernel_in(cluster, ev, K_PLACE)
    return kin._replace(used_disk=used_disk,
                        ask_disk=np.asarray(150.0, np.float32))


def compare_loops(kres, tres, kin, ctx: str) -> dict:
    """The kernel_topk loop against the torch loop: placed exact,
    score_sum to rel 1e-5, final used planes within 1e-2. Both commit
    every accepted placement of a batch (optimistic concurrency), so a
    node may end over capacity in both; the counts must agree."""
    ks, kp, kf, ku, km = kres
    ts, tp_, tf, tu, tm = tres
    check(int(kp) == int(tp_), f"{ctx}: placed {int(kp)} vs {int(tp_)}")
    rel = abs(float(ks) - float(ts)) / max(abs(float(ts)), 1e-30)
    check(rel <= 1e-5, f"{ctx}: score_sum rel error {rel}")
    err = max(float((ku - tu).abs().max()), float((km - tm).abs().max()))
    check(err <= 1e-2, f"{ctx}: final planes differ by {err}")
    check(bool(torch.isfinite(ku).all() and torch.isfinite(km).all()),
          f"{ctx}: non-finite planes")
    over = (over_capacity(kin, ku, km), over_capacity(kin, tu, tm))
    check(over[0] == over[1], f"{ctx}: over-capacity nodes {over}")
    return {"placed": int(kp), "score_sum": float(ks),
            "score_sum_rel_err": rel, "plane_err": err,
            "fallback_kernel_topk": int(kf), "fallback_torch": int(tf),
            "over_capacity_nodes": over[0]}


# ---------------------------------------------------------------------------
# Phase 10: the scheduler path, from evaluations to committed plans.
# ---------------------------------------------------------------------------

SCHED_NODES = c2m.N_NODES     # the C2M replay cluster: 10,000 nodes
SCHED_ALLOCS = c2m.N_ALLOCS   # and 100,000 live allocations
SCHED_ROUNDS = 8
SCHED_EVALS = 32     # evals per round, one thread each (the worker batch)
SCHED_SINGLE = 8     # evals through the single-eval launcher


def store_over_capacity(state, clusters) -> int:
    """Nodes whose committed cpu, memory or disk in the store's usage
    planes exceeds their capacity net of the agent's reserve."""
    snap = state.snapshot()
    c = clusters.get(snap)
    used = c.gathered_usage(snap.usage)
    over = np.zeros(c.n_pad, bool)
    for plane, cap in zip(used[:3], (c.cap_cpu, c.cap_mem, c.cap_disk)):
        over |= plane > cap + 1e-3
    return int(over.sum())


class TimedHarness(Harness):
    """The ``Harness`` with its plan commit timed in two parts: the plan's
    deferred work (allocation metrics, read from the wave's top-k) and
    the store's commit, the wait for the harness lock included."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.deferred_s: list = []
        self.commit_s: list = []

    def submit_plan(self, plan):
        t0 = time.perf_counter()
        plan.run_deferred()
        t1 = time.perf_counter()
        out = super().submit_plan(plan)
        self.deferred_s.append(t1 - t0)
        self.commit_s.append(time.perf_counter() - t1)
        return out


class GcPauses:
    """A ``gc.callbacks`` entry: collections of the oldest generation and
    the seconds spent in all collections while it is registered."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.full = 0
        self._t0 = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0
            self.full += int(info["generation"] == 2)


def check_evals(harness, jobs, evals, ctx: str) -> None:
    """Every eval complete, no blocked eval, each job with its
    placements live in the store."""
    status = {e.id: e.status for e in harness.evals}
    bad = [e.id for e in evals
           if status.get(e.id) != consts.EVAL_STATUS_COMPLETE]
    check(not bad, f"{ctx}: {len(bad)} evals not complete, e.g. "
          f"{[status.get(b) for b in bad[:3]]}")
    check(not harness.create_evals,
          f"{ctx}: {len(harness.create_evals)} blocked or follow-up evals")
    snap = harness.state.snapshot()
    for job in jobs:
        live = [a for a in snap.allocs_by_job(job.namespace, job.id)
                if not a.terminal_status()]
        check(len(live) == c2m.BURST_COUNT,
              f"{ctx}: job {job.id} has {len(live)} live allocs")


def new_evals(harness, rng, first: int, n: int):
    """``n`` burst jobs registered in the store, one eval each."""
    jobs = [c2m.burst_job(rng, first + i, prefix="smoke") for i in range(n)]
    for job in jobs:
        harness.state.upsert_job(job)
    evals = [mock.eval(job_id=j.id, namespace=j.namespace, type=j.type,
                       priority=j.priority) for j in jobs]
    harness.state.upsert_evals(evals)
    return jobs, evals


def candidate_entry(cand: dict) -> dict:
    """The candidate-set kernel's entry of the kernels line: phase 10's
    single evals (its launches on the main path) and its times on one
    eval's planes there."""
    return {
        "name": "candidate_eval_place",
        "route": "cuda",
        "source": "nomad_tpu_torch/csrc/candidate_set.cu",
        "replaces": "nomad_tpu/ops/kernel.py:974",
        "launches": cand["launches"],
        "max_abs_err": cand["max_abs_err"],
        "ms": cand["ms"],
        "plain_ms": cand["plain_ms"],
        "bound_ms": cand["bound_ms"],
        "bound_by": cand["bound_by"],
        "library_ms": None,
        "call_ms": cand["call_ms"],
        "joint_eval_ms": cand["joint_eval_ms"],
    }


def candidate_vs_plain(one, k_steps: int, features, ctx: str,
                       out=None) -> float:
    """The candidate-set kernel (``ck.candidate_eval_place``,
    csrc/candidate_set.cu) against its plain version
    (``place_taskgroup_topk``, torch ops) on the same tensors on the card:
    every output and ``valid`` equal bit for bit; ``out`` is the kernel's
    ``(KernelOut, valid)`` where it already ran. Returns the max abs error
    of the scores (0.0)."""
    got, ok = out if out is not None else ck.candidate_eval_place(
        one, k_steps, features)
    want, want_ok = place_taskgroup_topk(one, k_steps, features)
    check(bool(ok) == bool(want_ok), f"{ctx}: valid {bool(ok)}, the plain "
          f"version's {bool(want_ok)}")
    for name in KernelOut._fields:
        check(torch.equal(getattr(got, name), getattr(want, name)),
              f"{ctx}: {name} differs from the plain version")
    return max(float((got.scores - want.scores).abs().max()),
               float((got.topk_scores - want.topk_scores).abs().max()))


def kernel_device_parts(fn, names, reps: int) -> tuple:
    """``({name: device ms a call, or None}, kernel launches a call)`` of
    the kernels whose names hold one of ``names`` (each kernel counted
    under the first it holds), from one profiler device trace (CUPTI) over
    ``reps`` calls of ``fn``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(names, 0.0)
    launches = 0
    for e in prof.key_averages():
        name = next((name for name in names if name in e.key), None)
        if name is not None:
            total[name] += (getattr(e, "device_time_total", 0)
                            or getattr(e, "cuda_time_total", 0))
            launches += e.count
    return ({name: (t / 1e3 / reps if t else None)
             for name, t in total.items()}, launches / reps)


def kernel_device_ms(fn, names, reps: int) -> tuple:
    """``(device ms a call, kernel launches a call)`` of the kernels whose
    names hold one of ``names``, from the profiler's device trace (CUPTI)
    over ``reps`` calls of ``fn``; ``(None, 0)`` where the trace shows no
    device time. The events around back-to-back calls measure the larger
    of this and the host's time to enqueue a call."""
    parts, launches = kernel_device_parts(fn, names, reps)
    total = sum(t for t in parts.values() if t)
    return (total or None), launches


def c_call_ms(fn, reps: int) -> float:
    """The device time in ms of one C call of a kernel, on the stream:
    ``fn`` makes one call through ``ck._call`` (a wrapper such as
    ``ck.candidate_eval_place``), and that C call, its arguments and
    buffers still alive, is repeated ``reps`` times back to back between
    CUDA events. A C call's own host work (its launches, a few us) is
    shorter than a kernel's, so the card runs the calls back to back and
    the time holds every launch of the call and what lies between them on
    the stream, without the wrapper's host work. The repeats bypass the
    wrapper and its count."""
    import ctypes

    real = ck._call
    got = []

    def timed(name, args, dev, what):
        real(name, args, dev, what)
        lib = ck._LIBS[name][0]
        arg = ctypes.byref(args)
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            for _ in range(reps):
                err = lib(arg, stream)
                if err != 0:
                    raise RuntimeError(f"{what} launch failed: cudaError "
                                       f"{err}")
            stop.record()
            stop.synchronize()
        got.append(start.elapsed_time(stop) / reps)

    ck._call = timed
    try:
        fn()
    finally:
        ck._call = real
    return got[0]


def candidate_set_time(kin, k_steps: int, features,
                       dev: torch.device) -> dict:
    """The single eval's candidate set on one eval's planes on ``dev``, as
    ``default_kernel_launch`` runs it (canonical features): the kernel held
    to its plain version, then over 10 calls each the kernel's device time
    (the profiler's, its two launches a call) and the CUDA-event ms of
    back-to-back calls (the wrapper's host work bounds those), the plain
    version's (torch ops) and the full-width joint kernel's
    (``ck.joint_eval_place``) on the same planes. The bound: the fused
    envelope's leaves of one eval read once and the outputs written once,
    against the pass's operations over every node and each active step's
    over the candidate rows. The kernel's device time a call comes from
    back-to-back C calls (``c_call_ms``); one profiler trace gives each
    launch's own (``pass_ms``, ``scan_ms``: the scan, the pass's
    programmatic dependent launch, may start while the pass runs)."""
    features = canonical_features(features)
    one = _upload_kin(kin, dev)
    err = candidate_vs_plain(one, k_steps, features, "sched/candidate set")

    def kernel():
        return ck.candidate_eval_place(one, k_steps, features)

    def plain():
        return place_taskgroup_topk(one, k_steps, features)

    def full():
        return ck.joint_eval_place(one, k_steps, features)

    times = {}
    for name, fn in (("call_ms", kernel), ("plain_ms", plain),
                     ("joint_eval_call_ms", full)):
        fn()
        times[name] = cuda_ms(fn, 10)
    parts, times["kernel_launches"] = kernel_device_parts(
        kernel, ("cand_pass_kernel", "cand_scan_kernel"), 10)
    times["pass_ms"] = parts["cand_pass_kernel"]
    times["scan_ms"] = parts["cand_scan_kernel"]
    times["ms"] = c_call_ms(kernel, 50)
    times["joint_eval_ms"], _ = kernel_device_ms(
        full, ("joint_wave_kernel",), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        kernel()
    times["host_ms"] = (time.perf_counter() - t0) * 1e2
    torch.cuda.synchronize()
    out, _ = kernel()
    n = int(one.cap_cpu.shape[-1])
    k_cand = min(n, max(2 * k_steps, k_steps + 8, TOPK))
    rows = k_cand + (k_steps if features.with_preferred else 0)
    active = min(int(one.n_steps), k_steps)
    nbytes = sum(getattr(one, name).nbytes for name, _ in ck._LEAVES)
    nbytes += sum(x.nbytes for x in out[:5]) + 4 * len(FUSED_METRIC_FIELDS)
    ops = (n * (OPS_PER_NODE_SCORE + OPS_PER_NODE_METRIC)
           + active * rows * (OPS_PER_NODE_SCORE + OPS_PER_NODE_SELECT))
    bound_ms, bound_by = bound(nbytes, ops)
    return {**times, "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "ops": ops,
            "k_steps": k_steps, "k_cand": k_cand, "rows": rows,
            "active_steps": active, "n": n}


class CandidateRecorder:
    """``ck.candidate_eval_place`` wrapped for the single evals: each call
    keeps a copy of its input planes and its outputs, so that every single
    eval's candidate set is held to the plain version afterwards; the
    copies' host seconds are kept apart from the evals' times."""

    def __init__(self) -> None:
        self.calls: list = []
        self.copy_s = 0.0
        self._real = ck.candidate_eval_place

    def __enter__(self):
        ck.candidate_eval_place = self
        return self

    def __exit__(self, *exc) -> None:
        ck.candidate_eval_place = self._real

    def __call__(self, kin, k_steps, features, n_candidates=0):
        out = self._real(kin, k_steps, features, n_candidates)
        t0 = time.perf_counter()
        copy = type(kin)(*[x.clone() for x in kin])
        self.calls.append((copy, k_steps, features, out))
        self.copy_s += time.perf_counter() - t0
        return out

    def check(self, ctx: str) -> float:
        """Every recorded call against the plain version; the max abs
        error."""
        return max((candidate_vs_plain(kin, k, f, f"{ctx} {i}", out)
                    for i, (kin, k, f, out) in enumerate(self.calls)),
                   default=0.0)


def run_sched_phase(dev: torch.device, record: dict) -> dict:
    """Phase 10: the C2M replay state in the port's store, then rounds of
    evals through ``new_scheduler`` with ``LaunchCoalescer.launch`` as the
    launcher (``Worker._process_batch`` without the broker), plans
    committed through the ``Harness``; B1 against its plain version on a
    wave of the members round 1 built; then evals one at a time through
    the default single-eval launcher."""
    t0 = time.perf_counter()
    store = c2m.generate(SCHED_NODES, SCHED_ALLOCS)
    state_s = time.perf_counter() - t0
    snap = store.snapshot()
    n_allocs = sum(1 for _ in snap.allocs_iter())
    t0 = time.perf_counter()
    cluster = default_incremental_cluster_cache.get(snap)
    first_build_s = time.perf_counter() - t0
    # one node's attributes change: the next snapshot's cluster planes
    # come from a dirty-row delta build
    node = store.snapshot().node_by_id(cluster.node_ids[17]).copy()
    node.attributes = dict(node.attributes, **{"smoke.touched": "1"})
    node.compute_class()
    store.upsert_node(node)
    deltas = default_incremental_cluster_cache.delta_builds
    t0 = time.perf_counter()
    cluster = default_incremental_cluster_cache.get(store.snapshot())
    incremental_build_s = time.perf_counter() - t0
    check(default_incremental_cluster_cache.delta_builds == deltas + 1,
          "the node update did not take the delta build")
    log(f"sched state: {SCHED_NODES} nodes, {n_allocs} allocs, "
        f"N={cluster.n_pad}; generate {state_s:.2f} s, first build "
        f"{first_build_s:.3f} s, incremental build "
        f"{incremental_build_s:.4f} s")

    harness = TimedHarness(state=store, device=dev)
    rng = np.random.default_rng(SEED + 10)
    members: list = []          # round 1's (thread, seq, kin, k, f)
    split = {"before_launch": [], "in_launch": [], "after_launch": []}
    round_s, waves, errors = [], 0, []
    ck.launches = 0
    coalesce.fused_wave_stats.reset()
    coalesce.wave_stats.reset()
    coalesce.upload_stats.reset()
    default_device_state.reset_stats()
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    for r in range(SCHED_ROUNDS):
        jobs, evals = new_evals(harness, rng, r * SCHED_EVALS, SCHED_EVALS)
        snap = harness.state.snapshot()
        clusters = coalesce.ClusterCache(dev)
        co = coalesce.LaunchCoalescer(SCHED_EVALS, device=dev,
                                      adaptive=False)

        def evaluator(i: int, job, ev) -> None:
            spans = []

            def launch(kin, k_steps, features):
                if r == 0:
                    members.append((i, len(spans), kin, k_steps, features))
                t_a = time.perf_counter()
                try:
                    return co.launch(kin, k_steps, features)
                finally:
                    spans.append((t_a, time.perf_counter()))

            t_start = time.perf_counter()
            try:
                new_scheduler(job.type, snap, harness, device=dev,
                              kernel_launch=launch,
                              cluster_provider=clusters.get).process(ev)
            except Exception as e:      # noqa: BLE001 - checked after join
                errors.append(f"round {r} eval {i}: {e!r}")
            finally:
                co.done()
            total = time.perf_counter() - t_start
            before = spans[0][0] - t_start if spans else total
            inside = sum(b - a for a, b in spans)
            split["before_launch"].append(before)
            split["in_launch"].append(inside)
            split["after_launch"].append(total - before - inside)

        threads = [threading.Thread(target=evaluator, args=(i, j, e))
                   for i, (j, e) in enumerate(zip(jobs, evals))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        round_s.append(time.perf_counter() - t0)
        check(not any(th.is_alive() for th in threads), f"round {r} hung")
        check(not errors, f"scheduler path errors: {errors[:3]}")
        waves += co.launches
        check_evals(harness, jobs, evals, f"round {r}")
        over = store_over_capacity(harness.state, clusters)
        check(over == 0, f"round {r}: {over} nodes over capacity")
    b1_launches = ck.launches
    gc.callbacks.remove(pauses)
    deferred_s, commit_s = sum(harness.deferred_s), sum(harness.commit_s)
    fstats = coalesce.fused_wave_stats.snapshot()
    wstats = coalesce.wave_stats.snapshot()
    dstate = default_device_state.snapshot()
    uploads = (coalesce.upload_stats.uploads, coalesce.upload_stats.bytes)
    check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
          f"scheduler waves fell back or failed: {fstats}")
    check(dstate["errors"] == 0, f"scheduler path: device state errors: "
          f"{dstate}")
    check(b1_launches == fstats["launches"] == waves,
          f"B1 launches {b1_launches} != fused waves {fstats} / "
          f"coalescer waves {waves}")
    check(b1_launches > 0, "the scheduler path never launched B1")
    evals_total = SCHED_ROUNDS * SCHED_EVALS
    log(f"sched burst: {evals_total} evals in {waves} waves, "
        f"{b1_launches} B1 launches, 0 fallbacks")

    # B1 against its plain version on round 1's members, in a fixed order
    members.sort(key=lambda m: (m[0], m[1]))
    check(all(m[4].with_shuffle for m in members),
          "a scheduler member without its shuffle plane")
    wave = coalesce.assemble_wave([m[2] for m in members],
                                  [m[3] for m in members],
                                  [m[4] for m in members], dev)
    got = ck.fused_wave_place(wave.kin, wave.step_member, wave.step_local,
                              wave.t_pad, wave.features)
    want = ck.fused_wave_place_reference(
        wave.kin, wave.step_member, wave.step_local, wave.t_pad,
        wave.features)
    torch.cuda.synchronize()
    vs_plain = compare(got, want, wave, "sched/round1")
    check(vs_plain["placed"] == len(members) * c2m.BURST_COUNT,
          f"sched/round1 wave placed {vs_plain['placed']}")
    log(f"sched b1 vs plain: {json.dumps(vs_plain)}")

    # the single-eval route: one eval at a time, default launcher on dev;
    # each eval's candidate set is recorded and held to the plain version
    # after the loop
    single_eval_stats.reset()
    ck.candidate_launches = 0
    single_s = []
    with CandidateRecorder() as recorder:
        for i in range(SCHED_SINGLE):
            jobs, evals = new_evals(harness, rng, 10_000 + i, 1)
            torch.cuda.synchronize()
            copy0 = recorder.copy_s
            t0 = time.perf_counter()
            harness.process(jobs[0].type, evals[0])
            single_s.append(time.perf_counter() - t0
                            - (recorder.copy_s - copy0))
            check_evals(harness, jobs, evals, f"single eval {i}")
    single = single_eval_stats.snapshot()
    candidate_launches = ck.candidate_launches
    check(single["topk"] + single["full"] - single["breaches"]
          == SCHED_SINGLE, f"single-eval launches {single}")
    check(candidate_launches == single["topk"] > 0,
          f"candidate kernel launches {candidate_launches} != the single "
          f"evals' candidate sets {single}")
    single_err = recorder.check("single eval")
    over = store_over_capacity(harness.state, coalesce.ClusterCache(dev))
    check(over == 0, f"single evals: {over} nodes over capacity")
    candidate_set = candidate_set_time(*members[0][2:5], dev)
    candidate_set["launches"] = candidate_launches
    candidate_set["max_abs_err"] = max(candidate_set["max_abs_err"],
                                       single_err)
    log(f"sched candidate set: {json.dumps(candidate_set)}")

    sched = {
        "nodes": SCHED_NODES, "allocs": n_allocs, "n_pad": cluster.n_pad,
        "state_s": state_s, "first_build_s": first_build_s,
        "incremental_build_s": incremental_build_s,
        "rounds": SCHED_ROUNDS, "evals": evals_total,
        "placements": evals_total * c2m.BURST_COUNT,
        "waves": waves, "b1_launches": b1_launches,
        "fallbacks": fstats["fallbacks"],
        "evals_per_s": evals_total / sum(round_s),
        "round_ms": float(np.mean(round_s)) * 1e3,
        "round_ms_each": [x * 1e3 for x in round_s],
        "round_ms_median": float(np.median(round_s)) * 1e3,
        "thread_ms": {k: float(np.mean(v)) * 1e3 for k, v in split.items()},
        # inside the threads' after-launch part, per eval: the plan's
        # deferred work and the store's commit (the harness lock's wait
        # included)
        "plan_deferred_ms": deferred_s / evals_total * 1e3,
        "plan_commit_ms": commit_s / evals_total * 1e3,
        "gc_s": pauses.seconds, "gc_full": pauses.full,
        "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
        "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
        "park_latency_p50_ms": wstats["park_latency_p50_ms"],
        # the rounds' waves only (the comparison wave and the single
        # evals come after these were read)
        "device_state": dstate,
        "wave_uploads": uploads[0], "wave_upload_bytes": uploads[1],
        "wave_upload_bytes_per_wave": uploads[1] / waves if waves else 0.0,
        "single_eval_ms": float(np.mean(single_s)) * 1e3,
        "single_eval_ms_each": [x * 1e3 for x in single_s],
        "single_eval_stats": single,
        "single_eval_copy_ms": recorder.copy_s / SCHED_SINGLE * 1e3,
        "candidate_launches": candidate_launches,
        "candidate_set": candidate_set,
        "b1_vs_plain": vs_plain,
    }
    log(f"sched: {json.dumps(sched)}")
    record["sched"] = sched
    t0 = time.perf_counter()
    state_bytes = harness.state.to_snapshot_bytes()
    sched["snapshot_bytes_s"] = time.perf_counter() - t0
    # after the bytes: phase 11's state stays the one earlier runs used
    record["system"] = run_system_harness(harness, dev)
    return sched, state_bytes


# ---------------------------------------------------------------------------
# Phase 11: the server, from job registration to the group commit.
# ---------------------------------------------------------------------------

SERVER_WARMUP_JOBS = 40     # the JAX bench's E2E_WARMUP_JOBS
SERVER_JOBS = 200           # the timed burst (E2E_JOBS)
SERVER_BATCH = 32           # worker_batch_size (E2E_BATCH_SIZE)
SERVER_DEADLINE_S = 300.0   # per burst; a burst that takes longer fails
#: (gc_tuning, coalesce_adaptive, jobs in the timed burst) of each arm,
#: in this order; the first arm's burst is half, to keep the smoke's time
#: with phase 13's worker processes
SERVER_ARMS = ((False, True, SERVER_JOBS // 2), (True, True, SERVER_JOBS),
               (True, False, SERVER_JOBS))
#: the arm at the server's default worker_batch_size of 1: every lean eval
#: through the single-eval launcher's candidate set, one kernel call each
SERVER_BATCH1_JOBS = 40


def rss_gb() -> float:
    """This process's resident memory (``VmRSS``), in GB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024 / 1e9
    return 0.0


def server_converged(srv, jobs, deadline: float) -> float:
    """Wait until the broker is empty, no worker holds an eval and every
    job has its allocations in the store (``bench/trace_report.py``'s
    steady burst waits on the broker the same way); returns the host
    clock at that moment. An eval leaves the worker's live set after its
    e2e sample is recorded."""
    want = len(jobs) * c2m.BURST_COUNT
    while time.time() < deadline:
        bs = srv.eval_broker.stats()
        if (bs["total_ready"] == 0 and bs["total_unacked"] == 0
                and bs["total_waiting"] == 0
                and not any(w._live for w in srv.workers)):
            t_done = time.perf_counter()
            snap = srv.state.snapshot()
            placed = sum(len(snap.allocs_by_job(j.namespace, j.id))
                         for j in jobs)
            if placed >= want:
                return t_done
        time.sleep(0.005)
    snap = srv.state.snapshot()
    statuses: dict = {}
    for e in snap.evals_iter():
        statuses[e.status] = statuses.get(e.status, 0) + 1
    fail(f"server burst of {len(jobs)} jobs did not converge: "
         f"{srv.eval_broker.stats()}, blocked {srv.blocked_evals.stats()}, "
         f"eval statuses {statuses}, waves {coalesce.wave_stats.snapshot()}, "
         f"device state {default_device_state.snapshot()}, "
         f"plan groups {plan_group_stats.snapshot()}")


def check_server_burst(srv, jobs, ctx: str) -> int:
    """Every job has its placements live, no eval failed but on rejected
    plans with its follow-up complete, none is left in the broker (its
    failed queue included), no node is over capacity. An eval whose plans
    were rejected too often fails with a blocked follow-up (Nomad's
    max-plan-attempts); the leader's failed-eval unblock loop releases
    that, and it places the job. Returns how many evals failed so."""
    snap = srv.state.snapshot()
    for job in jobs:
        live = [a for a in snap.allocs_by_job(job.namespace, job.id)
                if not a.terminal_status()]
        check(len(live) == c2m.BURST_COUNT,
              f"{ctx}: job {job.id} has {len(live)} live allocs")
    def completed_later(ev) -> bool:
        # a follow-up that failed on its plans again has its own
        while (ev is not None and ev.status == consts.EVAL_STATUS_FAILED
               and ev.status_description.startswith("maximum attempts")
               and ev.blocked_eval):
            ev = snap.eval_by_id(ev.blocked_eval)
        return ev is not None and ev.status == consts.EVAL_STATUS_COMPLETE

    failed = [e for e in snap.evals_iter()
              if e.status == consts.EVAL_STATUS_FAILED]
    followed = [e for e in failed if completed_later(e)]
    check(len(followed) == len(failed),
          f"{ctx}: {len(failed) - len(followed)} failed evals "
          f"({len(failed)} failed, {len(followed)} of them on rejected "
          "plans with their follow-up complete)")
    bs = srv.eval_broker.stats()
    check(bs["total_ready"] == bs["total_unacked"] == bs["total_waiting"]
          == 0, f"{ctx}: broker not empty: {bs}")
    errors = [w.last_error for w in srv.workers if w.last_error]
    check(not errors, f"{ctx}: worker errors: {errors[:1]}")
    over = store_over_capacity(srv.state, coalesce.ClusterCache(srv.device))
    check(over == 0, f"{ctx}: {over} nodes over capacity")
    return len(followed)


def server_arm(dev: torch.device, state_bytes: bytes, gc_tuning: bool,
               adaptive: bool, n_jobs: int, rng,
               batch: int = SERVER_BATCH) -> dict:
    """One ``Server`` on ``dev`` over the restored state, its worker taking
    ``batch`` evals at a time: warm-up, then the timed burst of
    ``n_jobs``, with every count set to 0 just before it. A batch of one
    places each eval through the single-eval launcher (no wave)."""
    ctx = (f"server gc_tuning={gc_tuning} coalesce_adaptive={adaptive}"
           f" worker_batch_size={batch}")
    # B1's server: no mesh, also on a host of several cards, where the
    # default would split its waves over every card
    srv = Server(ServerConfig(num_workers=1, worker_batch_size=batch,
                              heartbeat_ttl=3600.0, gc_tuning=gc_tuning,
                              coalesce_adaptive=adaptive,
                              use_device_mesh=False),
                 device=dev)
    t0 = time.perf_counter()
    srv.state.restore_from_bytes(state_bytes)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    threads = threading.active_count()
    w = srv.workers[0]
    try:
        tag = ("gcon" if gc_tuning else "gcoff") + (
            "" if adaptive else "-full") + (
            "" if batch == SERVER_BATCH else f"-b{batch}")
        warm = [c2m.burst_job(rng, i, prefix=f"{tag}-warm")
                for i in range(SERVER_WARMUP_JOBS)]
        t0 = time.perf_counter()
        for job in warm:
            srv.job_register(job)
        warmup_s = server_converged(
            srv, warm, time.time() + SERVER_DEADLINE_S) - t0
        check_server_burst(srv, warm, f"{ctx} warm-up")

        jobs = [c2m.burst_job(rng, i, prefix=f"{tag}-burst")
                for i in range(n_jobs)]
        histograms.get("e2e").reset()
        srv.plan_latencies.clear()
        plan_group_stats.reset()
        coalesce.fused_wave_stats.reset()
        coalesce.wave_stats.reset()
        coalesce.upload_stats.reset()
        default_device_state.reset_stats()
        waves0, requests0 = w.batch_launches, w.batch_requests
        released0 = srv.failed_evals_unblocked
        pauses = GcPauses()
        single_eval_stats.reset()
        ck.launches = 0
        ck.candidate_launches = 0
        gc.callbacks.append(pauses)
        t0 = time.perf_counter()
        for job in jobs:
            srv.job_register(job)
        t_done = server_converged(srv, jobs,
                                  time.time() + SERVER_DEADLINE_S)
        gc.callbacks.remove(pauses)
        b1_launches = ck.launches
        candidate_launches = ck.candidate_launches
        single = single_eval_stats.snapshot()
        burst_s = t_done - t0
        dstate = default_device_state.snapshot()
        uploads = (coalesce.upload_stats.uploads,
                   coalesce.upload_stats.bytes)
        fstats = coalesce.fused_wave_stats.snapshot()
        e2e = histograms.get("e2e")
        e2e_n = e2e.count
        e2e_p50, e2e_p99 = e2e.quantiles((0.5, 0.99))
        plan_lat = list(srv.plan_latencies)
        group = plan_group_stats.snapshot()
        wstats = coalesce.wave_stats.snapshot()
        rss = rss_gb()
        ineligible = sum(
            1 for n in srv.state.snapshot().nodes()
            if n.scheduling_eligibility == consts.NODE_SCHEDULING_INELIGIBLE)
        plan_failed = check_server_burst(srv, jobs, ctx)
        released = srv.failed_evals_unblocked - released0
        resident = None if adaptive else check_resident(srv, dev, ctx)
    finally:
        t0 = time.perf_counter()
        srv.shutdown()
        shutdown_s = time.perf_counter() - t0
    # the worker's run loop has ended, so its last chunk is reaped
    waves = w.batch_launches - waves0
    requests = w.batch_requests - requests0
    check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
          f"{ctx}: waves fell back or failed: {fstats}")
    check(b1_launches == fstats["launches"],
          f"{ctx}: B1 launches {b1_launches} != fused waves {fstats}")
    check(candidate_launches == single["topk"],
          f"{ctx}: {candidate_launches} candidate kernel calls for the "
          f"single evals' candidate sets {single}")
    if batch == 1:
        # every eval alone: no wave, each lean eval's candidate set one
        # call of its kernel, the full width only where it breached
        check(b1_launches == 0 and single["topk"] >= n_jobs
              and single["full"] == single["breaches"],
              f"{ctx}: {b1_launches} B1 launches, single evals {single} "
              f"for {n_jobs} evals")
    else:
        check(1 <= b1_launches < n_jobs,
              f"{ctx}: {b1_launches} B1 launches for {n_jobs} evals")
    # an eval processed again (a blocked eval released) adds a sample
    check(e2e_n >= n_jobs, f"{ctx}: {e2e_n} e2e samples")
    check(dstate["errors"] == 0,
          f"{ctx}: device state errors: {dstate}")
    return {
        "gc_tuning": gc_tuning, "coalesce_adaptive": adaptive,
        "worker_batch_size": batch,
        "restore_s": restore_s, "start_s": start_s,
        "threads_after_start": threads, "rss_gb": rss,
        "warmup_s": warmup_s, "shutdown_s": shutdown_s,
        "evals": n_jobs, "e2e_samples": e2e_n, "burst_s": burst_s,
        "evals_per_s": n_jobs / burst_s,
        "e2e_p50_ms": e2e_p50 * 1e3, "e2e_p99_ms": e2e_p99 * 1e3,
        "plan_p50_ms": percentile(plan_lat, 0.5) * 1e3,
        "plan_p99_ms": percentile(plan_lat, 0.99) * 1e3,
        "plans": len(plan_lat),
        "b1_launches": b1_launches, "waves": waves,
        "candidate_launches": candidate_launches,
        "single_eval_stats": single,
        "wave_fill": requests / waves if waves else 0.0,
        "deadline_waves": wstats["deadline_launches"],
        "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
        "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
        "fallbacks": fstats["fallbacks"],
        "gc_full": pauses.full, "gc_s": pauses.seconds,
        "group_commits": group["commit_batches"],
        "group_size_avg": group["group_size_avg"],
        "vector_plans": group["vector_plans"],
        "fallback_plans": group["fallback_plans"],
        "rejected_node_plans": group["rejected_node_plans"],
        # evals of the arm's store that failed on rejected plans, and the
        # blocked follow-ups the leader's failed-eval unblock loop
        # released in the burst
        "plan_failed_evals": plan_failed,
        "released_evals": released,
        "ineligible_nodes": ineligible,
        "device_state": dstate,
        "wave_uploads": uploads[0], "wave_upload_bytes": uploads[1],
        "wave_upload_bytes_per_wave": uploads[1] / waves if waves else 0.0,
        "resident_check": resident,
    }


#: rows of one scatter advance timed below: a committed wave of 32 evals
#: x 10 placements moves at most 320 rows of the five usage planes
SCATTER_ROWS = 320


def check_resident(srv, dev: torch.device, ctx: str) -> dict:
    """The resident generation of the store's final snapshot, advanced to
    it by dirty-row scatter, must equal a fresh ``ClusterTensors.build``
    of that snapshot uploaded whole (``torch.equal``, plane by plane,
    dtype by dtype). Then the scatter's time per advance on the card:
    ``SCATTER_ROWS`` rows of the five usage planes, from the host buffer
    (one packed upload, five ``index_copy``) and on the card alone."""
    snap = srv.state.snapshot()
    cluster = coalesce.ClusterCache(dev).get(snap)
    t0 = time.perf_counter()
    res = default_device_state.check_fresh(snap, dev)
    check_s = time.perf_counter() - t0
    check(res["resident"] and res["differ"] == [],
          f"{ctx}: resident planes of the final snapshot against a fresh "
          f"upload: {res}")
    planes = default_device_state.planes_for(snap.usage, dev)
    usage_host = {f: planes[f].cpu().numpy()
                  for f in ClusterTensors.WAVE_USAGE_FIELDS}
    step = max(cluster.n_real // SCATTER_ROWS, 1)
    rows = set(range(0, step * SCATTER_ROWS, step))
    private = DeviceClusterState()      # keeps the server's stats clean
    advance_ms = cuda_ms(
        lambda: private._scatter(planes, usage_host, rows, dev), 50)
    rows_d = torch.tensor(sorted(rows), dtype=torch.long, device=dev)
    vals = {f: planes[f][rows_d] for f in usage_host}
    device_ms = cuda_ms(lambda: [planes[f].index_copy(0, rows_d, vals[f])
                                 for f in usage_host], 200)
    n = int(cluster.n_pad)
    return {"planes": len(planes), "check_s": check_s,
            "scatter_rows": len(rows), "scatter_planes": len(usage_host),
            "scatter_bytes": private.bytes_uploaded // 50,
            "scatter_advance_ms": advance_ms,
            "scatter_device_ms": device_ms,
            # each out-of-place index_copy reads and writes its plane
            "scatter_bound_ms": bound(
                len(usage_host) * (2 * 4 * n + 4 * len(rows)) + 8 * len(rows),
                0)[0]}


def run_server_phase(dev: torch.device, record: dict,
                     state_bytes: bytes) -> list:
    """Phase 11: ``gc_tuning`` off, then on, then on with the coalescer's
    adaptive window off (a wave waits for every member of its batch).
    The server's GC treatment freezes what is alive once per process, so
    the "off" arm must come first, and each arm's server is dropped and
    collected before the next one starts (the third arm's heap is not
    frozen: a server started again in a process is not frozen either)."""
    if os.environ.pop("NOMAD_TPU_GC_TUNING", None) is not None:
        log("server: NOMAD_TPU_GC_TUNING was set; unset for phase 11")
    # the arms warm nothing: no manifest outside this run may be read
    kernel_warmup.DEFAULT_MANIFEST_PATH = str(
        Path(__file__).resolve().parent / "build" / "no_manifest.json")
    log(f"server state: {len(state_bytes) / 1e6:.1f} MB of snapshot bytes")
    rng = np.random.default_rng(SEED + 11)
    arms = []
    for gc_tuning, adaptive, n_jobs in SERVER_ARMS:
        arm = server_arm(dev, state_bytes, gc_tuning, adaptive, n_jobs, rng)
        t0 = time.perf_counter()
        gc.collect()
        arm["collect_after_s"] = time.perf_counter() - t0
        log(f"server: {json.dumps(arm)}")
        log(f"server: gc_tuning={gc_tuning} coalesce_adaptive={adaptive}: "
            f"{arm['released_evals']} evals released by the failed-eval "
            f"unblock loop, {arm['plan_failed_evals']} failed on rejected "
            f"plans, {arm['rejected_node_plans']} rejected node plans")
        arms.append(arm)
    record["server"] = arms
    one = server_arm(dev, state_bytes, True, True, SERVER_BATCH1_JOBS, rng,
                     batch=1)
    gc.collect()
    log(f"server batch 1: {json.dumps(one)}")
    log(f"server batch 1: {one['evals_per_s']:.1f} evals/s, e2e p50 "
        f"{one['e2e_p50_ms']:.2f} ms, single evals "
        f"{one['single_eval_stats']}, {one['candidate_launches']} "
        "candidate kernel calls")
    record["server_batch1"] = one
    return arms


# ---------------------------------------------------------------------------
# Phase 12: the warm start on the server path, in fresh processes.
# ---------------------------------------------------------------------------

WARM_CHILD_TIMEOUT_S = 420.0    # per child process; killed when it is over
WARMUP_WAIT_S = 240.0           # the child's wait for its warmup thread


def run_warm_start_phase(record: dict, state_bytes: bytes) -> list:
    """Phase 12: fresh Python processes (no CUDA context, no library
    loaded) each restore phase 11's snapshot bytes into a server with
    ``kernel_warmup=True`` and one manifest path, the profiler on, and run
    the timed burst. Run A finds no manifest, warms nothing and persists
    one at shutdown; run B warms it at ``start()``, waits for the warmup,
    then bursts; run C warms it too but bursts at once, as a server that
    does not wait for its warmup. Runs B and C must warm at least one
    entry and fail none, and run B must miss no key in its burst (run
    C's waves may race the warmup to a key; its misses are reported)."""
    runs = []
    with tempfile.TemporaryDirectory(prefix="warm_start_") as tmp:
        state_path = Path(tmp) / "state.bin"
        state_path.write_bytes(state_bytes)
        manifest = Path(tmp) / "warmup.json"
        for run in ("A", "B", "C"):
            check((run != "A") == manifest.exists(),
                  f"warm start {run}: manifest exists={manifest.exists()}")
            out = Path(tmp) / f"run{run}.json"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--warm-start", run, str(state_path), str(manifest),
                     str(out)], capture_output=True, text=True,
                    timeout=WARM_CHILD_TIMEOUT_S,
                    cwd=str(Path(__file__).resolve().parent))
            except subprocess.TimeoutExpired:
                fail(f"warm start {run}: over {WARM_CHILD_TIMEOUT_S} s")
            for line in proc.stdout.splitlines():
                log(f"warm start {run}: {line}")
            check(proc.returncode == 0,
                  f"warm start {run} failed (exit {proc.returncode}): "
                  f"{proc.stderr[-3000:]}")
            res = json.loads(out.read_text())
            res["process_s"] = time.perf_counter() - t0
            runs.append(res)
        entries = kernel_warmup.load_manifest(str(manifest))
    # the server's own keys: phase 17 part C's server warms them too
    record["warm_start_manifest"] = entries
    a, b, c = runs
    check(a["warmup"]["warmed"] == 0 and a["warmup"]["failed"] == 0,
          f"warm start A warmed {a['warmup']}")
    for r in (b, c):
        check(r["warmup"]["failed"] == 0 and r["warmup"]["warmed"] >= 1,
              f"warm start {r['run']}: warmup {r['warmup']}")
    check(b["burst_profile"]["Misses"] == 0,
          f"warm start B: misses in the burst: {b['burst_profile']['PerKey']}")
    for r in runs:
        r["manifest_entries"] = len(entries)
        log(f"warm start: {json.dumps(r)}")
    record["warm_start"] = runs
    return runs


def warm_start_alone(argv: list) -> int:
    """``chip_smoke.py --warm-start RUN STATE MANIFEST OUT [--mesh]
    [--device cpu] [--jobs N]``: one child of phase 12, or with
    ``--mesh`` of ``--mesh-phase``'s warm start."""
    import argparse

    ap = argparse.ArgumentParser(prog="chip_smoke.py --warm-start")
    ap.add_argument("run", choices=("A", "B", "C"))
    ap.add_argument("state")
    ap.add_argument("manifest")
    ap.add_argument("out")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--jobs", type=int, default=SERVER_JOBS)
    a = ap.parse_args(argv)
    return warm_start_child(a.run, a.state, a.manifest, a.out,
                            device=a.device, mesh=a.mesh, n_jobs=a.jobs)


#: --mesh-phase's warm start: probe jobs a run places before its burst,
#: each pinned to a rack of its own, so a wave's placements do not depend
#: on the order its members arrive in (runs A and B must place them alike)
PROBE_JOBS = 32


def place_probe(srv, ctx: str) -> dict:
    """Register ``PROBE_JOBS`` jobs of the C2M mix's smallest service
    shape, job i pinned to rack r<i>, with the worker stopped and each
    eval id drawn from a seed (the same ids, so the same shuffles, in
    every run); wait for them; return each alloc's node by alloc name."""
    import random
    import uuid

    from nomad_tpu_torch.structs import eval_plan
    from nomad_tpu_torch.structs.constraints import Constraint

    rng = np.random.default_rng(SEED + 160)
    jobs = []
    for i in range(PROBE_JOBS):
        job = c2m._make_job(rng, i, c2m.LEAN_SHAPES[0])
        job.id = f"probe-{i}"
        job.task_groups[0].count = c2m.BURST_COUNT
        job.constraints = list(job.constraints) + [Constraint(
            ltarget="${attr.platform.aws.placement.rack}",
            rtarget=f"r{i}", operand="=")]
        jobs.append(job)
    for w in srv.workers:
        w.stop()
    try:
        for i, job in enumerate(jobs):
            eval_plan._UUID_RNG = random.Random(SEED + 16_000 + i)
            srv.job_register(job)
    finally:
        eval_plan._UUID_RNG = random.Random(uuid.uuid4().int)
        for w in srv.workers:
            w.start()
    server_converged(srv, jobs, time.time() + SERVER_DEADLINE_S)
    check_server_burst(srv, jobs, f"{ctx} probe")
    snap = srv.state.snapshot()
    return {a.name: a.node_id for j in jobs
            for a in snap.allocs_by_job(j.namespace, j.id)}


def sharded_misses() -> int:
    """The profiler's misses of sharded waves since its last reset."""
    return sum(profiler.misses_for(k) for k in ("fused_wave_sharded",
                                                "joint_sharded"))


def warm_start_child(run: str, state_path: str, manifest: str,
                     out_path: str, device: str = "cuda",
                     mesh: bool = False, n_jobs: int = SERVER_JOBS) -> int:
    """One run of phase 12 in its own process: restore, ``start()``
    (run B then waits for the warmup; runs A and C do not), the timed
    burst with every count set to 0 just before it, shutdown (which
    persists the manifest); the result goes to ``out_path`` as JSON.
    A warmup that overlaps the burst (run C) is joined before the counts
    are read, and its B1 launches are taken out of the burst's.
    ``device`` is the card; a rehearsal on the CPU names ``cpu``.

    ``mesh``: the server's waves run over a mesh: its own over the cards
    on a host of several (``use_device_mesh=None``), else a virtual
    4-shard mesh on the card adopted after ``start()``, whose mesh-only
    warm pass runs on its own thread. Runs A and B place the probe jobs
    (``place_probe``) before the burst; the waves must all run sharded,
    with no B1 launch."""
    dev = torch.device(device)
    check(dev.type != "cuda" or torch.cuda.is_available(),
          "warm start: no CUDA card")
    ctx = f"warm start {run}" + (" (mesh)" if mesh else "")
    profiler.enable()
    srv = Server(ServerConfig(num_workers=1, worker_batch_size=SERVER_BATCH,
                              heartbeat_ttl=3600.0, coalesce_adaptive=False,
                              kernel_warmup=True,
                              warmup_manifest_path=manifest),
                 device=dev)
    t0 = time.perf_counter()
    srv.state.restore_from_bytes(Path(state_path).read_bytes())
    restore_s = time.perf_counter() - t0
    first_done = []
    launch_s = []       # each launch_wave call's own seconds
    real_launch = coalesce.launch_wave

    def timed_launch(*args, **kwargs):
        t = time.perf_counter()
        out = real_launch(*args, **kwargs)
        launch_s.append(time.perf_counter() - t)
        if not first_done:
            first_done.append(time.perf_counter())
        return out

    coalesce.launch_wave = timed_launch
    ck.launches = 0
    kernel_warmup.warmup_stats.reset()
    t_start = time.perf_counter()
    srv.start()
    if mesh and srv.wave_mesh is None:
        srv._adopt_wave_mesh(sharded.wave_mesh(
            devices=[dev] * MESH_SERVER_SHARDS))
    start_s = time.perf_counter() - t_start
    w = srv.workers[0]
    probe: dict = {}
    try:
        warm = {"warmed": 0, "failed": 0, "seconds": 0.0, "wait_s": 0.0,
                "launches": {}, "b1_launches": 0}

        def join_warmup() -> None:
            threads = [t for t in (srv._warmup_thread,
                                   srv._mesh_warmup_thread) if t is not None]
            for t in threads:
                t.join(timeout=WARMUP_WAIT_S)
                check(not t.is_alive(),
                      f"{ctx}: warmup still running after {WARMUP_WAIT_S} s")
            if threads:
                warm.update(srv.warmup_stats or {"failed": 1})
                warm["passes"] = srv.warmup_passes

        if run == "B":
            join_warmup()
            warm["wait_s"] = time.perf_counter() - t_start
            warm["launches"] = kernel_warmup.warmup_stats.snapshot()
            warm["b1_launches"] = ck.launches
            warm["profile"] = profiler.summary()
            del warm["profile"]["PerKey"]
        first_wave_ms = None
        if mesh and run != "C":
            # the process's first wave is the probe's
            profiler.reset()
            probe["placements"] = place_probe(srv, ctx)
            probe["sharded_misses"] = sharded_misses()
            probe["per_key"] = profiler.summary()["PerKey"]
            first_wave_ms = coalesce.wave_stats._wave_s[0] * 1e3

        rng = np.random.default_rng(SEED + 12)
        jobs = [c2m.burst_job(rng, i, prefix=f"warm{run}")
                for i in range(n_jobs)]
        histograms.get("e2e").reset()
        srv.plan_latencies.clear()
        if not probe:
            # (after a probe the profiler keeps its keys for the manifest;
            # the burst's misses are counted from the probe's on)
            profiler.reset()
        coalesce.fused_wave_stats.reset()
        coalesce.wave_stats.reset()
        coalesce.upload_stats.reset()
        coalesce.sharded_wave_stats.reset()
        default_device_state.reset_stats()
        waves0, requests0 = w.batch_launches, w.batch_requests
        if run != "C":
            ck.launches = 0     # run C counts from start(): see below
        burst0 = len(launch_s)
        if mesh:
            # the batches, so the waves' keys, in registration order: the
            # same in every run
            w.stop()
        t0 = time.perf_counter()
        for job in jobs:
            srv.job_register(job)
        if mesh:
            w.start()
        t_done = server_converged(srv, jobs,
                                  time.time() + SERVER_DEADLINE_S)
        burst_s = t_done - t0
        warm_b1 = 0
        if run == "C":
            # the warmup overlapped the burst: once it has ended, every
            # B1 launch since start() less its dummy waves is the burst's
            join_warmup()
            warm["launches"] = kernel_warmup.warmup_stats.snapshot()
            warm_b1 = warm["b1_launches"] = warm["launches"].get(
                "fused_wave", 0)
        b1_launches = ck.launches - warm_b1
        # first launches of the live kernels (a racing warmup's own
        # first launches count under warmup_<kernel>)
        live_misses = sum(profiler.misses_for(k) for k in (
            "fused_wave", "joint", "single_topk", "single_full",
            "fused_wave_sharded", "joint_sharded"))
        burst_sharded_misses = sharded_misses() - probe.get(
            "sharded_misses", 0)
        fstats = coalesce.fused_wave_stats.snapshot()
        sstats = coalesce.sharded_wave_stats.snapshot()
        wstats = coalesce.wave_stats.snapshot()
        if first_wave_ms is None:
            first_wave_ms = coalesce.wave_stats._wave_s[0] * 1e3
        first_assemble_ms = coalesce.wave_stats._assemble_s[0] * 1e3
        # the burst's launch_wave calls after the process's first
        warm_launch = launch_s[max(burst0, 1):]
        prof = profiler.summary()
        dstate = default_device_state.snapshot()
        uploads = (coalesce.upload_stats.uploads,
                   coalesce.upload_stats.bytes)
        e2e_p50, e2e_p99 = histograms.get("e2e").quantiles((0.5, 0.99))
        check_server_burst(srv, jobs, ctx)
    finally:
        srv.shutdown()
        coalesce.launch_wave = real_launch
    waves = w.batch_launches - waves0
    requests = w.batch_requests - requests0
    check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
          f"{ctx}: waves fell back or failed: {fstats}")
    if mesh:
        # (on the CPU no B1 launch is counted, the warmup's included)
        check((b1_launches == 0 or dev.type != "cuda")
              and sstats["launches"] == fstats["launches"]
              == waves and sstats["fallbacks"] == 0,
              f"{ctx}: B1 launches {b1_launches}, sharded {sstats}, fused "
              f"{fstats}, waves {waves}")
    else:
        check(b1_launches == fstats["launches"] == waves,
              f"{ctx}: B1 launches {b1_launches}, fused {fstats}, waves "
              f"{waves}")
    check(dstate["errors"] == 0, f"{ctx}: device state errors: {dstate}")
    check(Path(manifest).exists(), f"{ctx}: no manifest after shutdown")
    res = {
        "run": run, "mesh": mesh, "restore_s": restore_s, "start_s": start_s,
        "warmup": warm,
        "start_to_first_wave_s": first_done[0] - t_start,
        "burst_to_first_wave_s": first_done[0] - t0,
        "first_wave_latency_ms": first_wave_ms,
        "first_wave_assemble_ms": first_assemble_ms,
        "first_launch_wave_ms": launch_s[0] * 1e3,
        "burst_launch_wave_warm_median_ms": (
            float(np.median(warm_launch)) * 1e3 if warm_launch else None),
        "burst_sharded_misses": burst_sharded_misses, "probe": probe,
        "sharded": sstats,
        "evals": len(jobs), "burst_s": burst_s,
        "evals_per_s": len(jobs) / burst_s,
        "e2e_p50_ms": e2e_p50 * 1e3, "e2e_p99_ms": e2e_p99 * 1e3,
        "b1_launches": b1_launches, "waves": waves,
        "wave_fill": requests / waves if waves else 0.0,
        "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
        "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
        "warmup_b1_in_burst": warm_b1, "live_misses": live_misses,
        "burst_profile": prof, "device_state": dstate,
        "wave_uploads": uploads[0], "wave_upload_bytes": uploads[1],
    }
    Path(out_path).write_text(json.dumps(res))
    log(f"burst: {b1_launches} B1 launches, {sstats['launches']} sharded, "
        f"in {waves} waves, misses {live_misses}, "
        f"{len(jobs) / burst_s:.1f} evals/s")
    return 0


# ---------------------------------------------------------------------------
# Phase 13: system jobs, and the server with scheduler worker processes.
# ---------------------------------------------------------------------------

#: the node agent's ask: a log shipper or monitoring agent on every node
AGENT_CPU = 100
AGENT_MEM = 64
#: the bool planes ``_feasible_mask`` reads back: the mask and six fit
#: planes
MASK_READBACK_PLANES = 7
#: the planes ``_feasible`` reads with every feature on, each once
MASK_PLANES = ("base_mask", "cap_cpu", "cap_mem", "cap_disk", "used_cpu",
               "used_mem", "used_disk", "free_cores", "used_cores",
               "free_dyn", "port_conflict", "dev_free", "used_mbits",
               "avail_mbits", "job_tg_count", "job_any_count")


def node_agent_job(job_type: str, tag: str):
    """One job of ``job_type`` (system or sysbatch) asking for a lean node
    agent on every node of the ten datacenters. Its priority is below
    every C2M job's (20-60), so it preempts nothing: a node it does not
    fit stays without it and is counted in ``failed_tg_allocs``."""
    job = mock.system_job(id=f"{tag}-{job_type}-agent", priority=10,
                          datacenters=[f"dc{i}" for i in range(1, 11)])
    job.type = job_type
    res = job.task_groups[0].tasks[0].resources
    res.cpu, res.memory_mb = AGENT_CPU, AGENT_MEM
    return job


def system_mask(snap, job, dev: torch.device) -> tuple:
    """``(cluster, base_mask, kin)`` of the job's task group on ``snap``,
    built as ``SystemScheduler`` builds it."""
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.stack import XLAGenericStack

    cluster = coalesce.ClusterCache(dev).get(snap)
    ctx = EvalContext(snap, mock.eval(job_id=job.id).make_plan(job),
                      device=dev)
    stack = XLAGenericStack(False, ctx, cluster)
    stack.set_job(job)
    ev = stack._build_eval_tensors(job.task_groups[0],
                                   np.zeros(cluster.n_pad, bool))
    return cluster, np.asarray(ev.base_mask), build_kernel_in(cluster, ev, 1)


def plain_fit(kin) -> np.ndarray:
    """The node agent's mask computed apart from the port: the base mask
    and free cpu, memory and disk against its ask, in f32 as the card
    computes them. Only for a lean ask (no cores, ports, devices,
    bandwidth or distinct hosts), which this checks."""
    k = {f: np.asarray(getattr(kin, f)) for f in (
        "base_mask", "cap_cpu", "cap_mem", "cap_disk", "used_cpu",
        "used_mem", "used_disk", "ask_cpu", "ask_mem", "ask_disk",
        "ask_cores", "ask_dyn_ports", "ask_has_reserved_ports", "ask_dev",
        "ask_mbits", "distinct_hosts_job", "distinct_hosts_tg")}
    check(k["ask_cores"] == 0 and k["ask_dyn_ports"] == 0
          and not k["ask_has_reserved_ports"] and not k["ask_dev"].any()
          and k["ask_mbits"] == 0 and not k["distinct_hosts_job"]
          and not k["distinct_hosts_tg"], "plain fit: the ask is not lean")
    return (k["base_mask"]
            & (k["cap_cpu"] - k["used_cpu"] >= k["ask_cpu"])
            & (k["cap_mem"] - k["used_mem"] >= k["ask_mem"])
            & (k["cap_disk"] - k["used_disk"] >= k["ask_disk"]))


def check_mask(kin, dev: torch.device, ctx: str) -> tuple:
    """``_feasible_mask`` of ``kin`` on ``dev``, the same on the CPU (mask
    and fit planes exact) and the plain fit (mask exact); returns
    ``(mask, nodes true, nodes false)`` over the base mask."""
    mask_d, dims_d = system_sched._feasible_mask(kin, dev)
    mask_c, dims_c = system_sched._feasible_mask(kin, "cpu")
    check(np.array_equal(mask_d, mask_c), f"{ctx}: _feasible_mask on "
          f"{dev} differs from the CPU")
    for name in dims_c:
        check(np.array_equal(dims_d[name], dims_c[name]),
              f"{ctx}: fit plane {name} differs on {dev}")
    plain = plain_fit(kin)
    check(np.array_equal(mask_d, plain), f"{ctx}: _feasible_mask differs "
          f"from the plain fit on {int((mask_d != plain).sum())} nodes")
    base = np.asarray(kin.base_mask)
    return mask_d, int(mask_d.sum()), int((base & ~mask_d).sum())


def expected_agents(snap, job, dev: torch.device) -> tuple:
    """``(node ids the job must place on, nodes it must count as
    exhausted)``: the ready nodes of the job's base mask where
    ``_feasible_mask`` is true, and where it is false; the mask held
    against the CPU and the plain fit first."""
    cluster, base, kin = system_mask(snap, job, dev)
    mask, _, _ = check_mask(kin, dev, f"{job.type} agent mask")
    want, exhausted = set(), 0
    for i in range(cluster.n_real):
        node = snap.node_by_id(cluster.node_ids[i])
        if node is None or not node.ready() or not base[i]:
            continue
        if mask[i]:
            want.add(cluster.node_ids[i])
        else:
            exhausted += 1
    return want, exhausted


def check_agents(snap, job, ev, want: set, exhausted: int,
                 ctx: str) -> int:
    """The job's eval is complete, one live alloc on every node of
    ``want`` and on no other, and ``exhausted`` nodes counted in its
    ``failed_tg_allocs``; returns the allocs placed."""
    check(ev.status == consts.EVAL_STATUS_COMPLETE,
          f"{ctx}: eval {ev.status}: {ev.status_description}")
    live = [a.node_id for a in snap.allocs_by_job(job.namespace, job.id)
            if not a.terminal_status()]
    check(len(live) == len(set(live)) == len(want) and set(live) == want,
          f"{ctx}: {len(live)} allocs on {len(set(live))} nodes, "
          f"{len(want)} feasible ready nodes, "
          f"{len(set(live) ^ want)} differ")
    tg = job.task_groups[0].name
    got = (ev.failed_tg_allocs[tg].nodes_exhausted
           if tg in ev.failed_tg_allocs else 0)
    check(got == exhausted, f"{ctx}: {got} nodes exhausted in "
          f"failed_tg_allocs, {exhausted} nodes do not fit")
    return len(live)


def run_system_harness(harness, dev: torch.device) -> dict:
    """A system job on phase 10's store through ``new_scheduler("system",
    ...)`` on the card: ``_feasible_mask`` on the card against the same
    ``KernelIn`` on the CPU (mask and fit planes exact), its time by CUDA
    events (the call as the scheduler makes it, and its device work on
    planes already on the card) beside its bound in bytes, then the eval,
    one alloc per feasible ready node."""
    job = node_agent_job(consts.JOB_TYPE_SYSTEM, "sched")
    harness.state.upsert_job(job)
    snap = harness.state.snapshot()
    cluster, _, kin = system_mask(snap, job, dev)
    check_mask(kin, dev, "system")
    # an ask of the median free cpu and memory: a large share of the
    # nodes do not fit, so the mask must hold both kinds of rows
    base = np.asarray(kin.base_mask)
    free_cpu = (np.asarray(kin.cap_cpu) - np.asarray(kin.used_cpu))[base]
    free_mem = (np.asarray(kin.cap_mem) - np.asarray(kin.used_mem))[base]
    heavy = kin._replace(
        ask_cpu=np.asarray(np.median(free_cpu), np.float32),
        ask_mem=np.asarray(np.median(free_mem), np.float32))
    _, heavy_fit, heavy_not = check_mask(heavy, dev, "system (median ask)")
    check(heavy_fit > 0 and heavy_not > heavy_fit // 4,
          f"system (median ask): {heavy_fit} nodes fit, {heavy_not} do not")
    on_card = _upload_kin(kin, dev)
    call_ms = cuda_ms(lambda: system_sched._feasible_mask(kin, dev), 20)
    # its device work alone, on planes already on the card
    device_ms = cuda_ms(lambda: system_sched._mask_stack(on_card), 50)
    n = int(cluster.n_pad)
    nbytes = sum(np.asarray(getattr(kin, f)).nbytes for f in MASK_PLANES)
    nbytes += MASK_READBACK_PLANES * n     # the bool planes read back
    want, exhausted = expected_agents(snap, job, dev)

    ev = mock.eval(job_id=job.id, namespace=job.namespace, type=job.type,
                   priority=job.priority)
    harness.state.upsert_evals([ev])
    plans0 = len(harness.plans)
    system_sched.mask_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    harness.process(job.type, ev)
    eval_s = time.perf_counter() - t0
    launches = system_sched.mask_launches
    done = [e for e in harness.evals if e.id == ev.id][-1]
    placed = check_agents(harness.state.snapshot(), job, done, want,
                          exhausted, "system (harness)")
    over = store_over_capacity(harness.state, coalesce.ClusterCache(dev))
    check(over == 0, f"system (harness): {over} nodes over capacity")
    check(launches == 1, f"system (harness): {launches} masks for one "
          "task group")
    res = {
        "nodes": cluster.n_real, "n_pad": n,
        "feasible_ready_nodes": len(want), "exhausted_nodes": exhausted,
        "placed": placed, "plans": len(harness.plans) - plans0,
        "eval_s": eval_s, "mask_launches": launches,
        "mask_call_ms": call_ms, "mask_device_ms": device_ms,
        "mask_bytes": nbytes, "mask_bound_ms": bound(nbytes, 0)[0],
        "mask_exact_vs_cpu": True,
        "median_ask_fit_nodes": heavy_fit,
        "median_ask_unfit_nodes": heavy_not,
    }
    log(f"system: {json.dumps(res)}")
    return res


def wait_eval(srv, eval_id: str, deadline: float):
    """The eval's row once it is no longer pending."""
    while time.time() < deadline:
        ev = srv.state.snapshot().eval_by_id(eval_id)
        if ev is not None and ev.status not in (
                consts.EVAL_STATUS_PENDING, consts.EVAL_STATUS_BLOCKED):
            return ev
        time.sleep(0.01)
    fail(f"eval {eval_id} still pending after the deadline")


def system_jobs_through(srv, dev: torch.device, tag: str) -> list:
    """A system job, then a sysbatch job, registered with ``srv``: each
    eval completes with one alloc on every feasible ready node."""
    out = []
    for job_type in (consts.JOB_TYPE_SYSTEM, consts.JOB_TYPE_SYSBATCH):
        job = node_agent_job(job_type, tag)
        want, exhausted = expected_agents(srv.state.snapshot(), job, dev)
        t0 = time.perf_counter()
        eval_id = srv.job_register(job)["eval_id"]
        ev = wait_eval(srv, eval_id, time.time() + SERVER_DEADLINE_S)
        eval_s = time.perf_counter() - t0
        ctx = f"{job_type} through worker processes"
        placed = check_agents(srv.state.snapshot(), job, ev, want,
                              exhausted, ctx)
        over = store_over_capacity(srv.state, coalesce.ClusterCache(dev))
        check(over == 0, f"{ctx}: {over} nodes over capacity")
        res = {"type": job_type, "eval_s": eval_s, "plan_allocs": placed,
               "feasible_ready_nodes": len(want),
               "exhausted_nodes": exhausted}
        log(f"system job: {json.dumps(res)}")
        out.append(res)
    return out


def child_row(handle_stats: dict) -> dict:
    """One worker process's line: the owner's view and the counters of its
    last heartbeat."""
    counters = handle_stats["counters"]
    waves = counters["waves"]
    return {
        "worker_id": handle_stats["worker_id"], "device": counters["device"],
        "processed": counters["processed"], "waves": waves,
        "wave_fill": counters["requests"] / waves if waves else 0.0,
        "b1_launches": counters["b1_launches"], "fused": counters["fused"],
        "mask_launches": counters["mask_launches"],
        "device_state_errors": counters["device_state"]["errors"],
        "delta_advances": counters["device_state"]["delta_advances"],
        "first_wave_ms": counters["first_wave_ms"],
        "rpcs": counters["rpcs"], "rpc_p50_ms": counters["rpc_p50_ms"],
        "rpc_p99_ms": counters["rpc_p99_ms"], "frames": counters["frames"],
        "frame_apply_s": counters["frame_apply_s"],
        "frame_apply_max_s": counters["frame_apply_max_s"],
        "frames_sent": handle_stats["frames_sent"],
        "bootstrap_bytes": handle_stats["bootstrap_bytes"],
        "bootstrap_send_s": handle_stats["bootstrap_s"],
        "bootstrap_apply_s": counters["bootstrap_apply_s"],
        "rss_gb": counters["rss_bytes"] / 1e9,
        "turn": counters["turn"],
    }


def workerproc_arm(dev: torch.device, state_bytes: bytes, workers: int,
                   rng, system_jobs: bool) -> dict:
    """Phase 11's window-off server with ``workers`` worker processes:
    warm-up, then the timed burst with every count (the owner's and each
    process's) set to 0 just before it; then, if asked, the system jobs."""
    from nomad_tpu_torch.state.store import leased_generation_count
    from nomad_tpu_torch.state.usage import usage_rebuild_diff

    ctx = f"workerproc S={workers}"
    card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    srv = Server(ServerConfig(num_workers=1, worker_batch_size=SERVER_BATCH,
                              heartbeat_ttl=3600.0, coalesce_adaptive=False,
                              scheduler_workers=workers),
                 device=dev)
    t0 = time.perf_counter()
    srv.state.restore_from_bytes(state_bytes)
    restore_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    sup = srv.worker_supervisor
    try:
        warm = [c2m.burst_job(rng, i, prefix=f"wp{workers}-warm")
                for i in range(SERVER_WARMUP_JOBS)]
        t0 = time.perf_counter()
        for job in warm:
            srv.job_register(job)
        warmup_s = server_converged(
            srv, warm, time.time() + SERVER_DEADLINE_S) - t0
        check_server_burst(srv, warm, f"{ctx} warm-up")
        sup.probe_all("reset")

        jobs = [c2m.burst_job(rng, i, prefix=f"wp{workers}-burst")
                for i in range(SERVER_JOBS)]
        for name in ("e2e", "worker_ipc", "worker_rpc_call",
                     "worker_rpc_sync", "placement_turn_wait"):
            histograms.get(name).reset()
        srv.plan_latencies.clear()
        plan_group_stats.reset()
        coalesce.fused_wave_stats.reset()
        ck.launches = 0
        reissues0 = sup.lease_reissues
        grants0 = sup.turn.grants if sup.turn is not None else 0
        t0 = time.perf_counter()
        for job in jobs:
            srv.job_register(job)
        t_done = server_converged(srv, jobs,
                                  time.time() + SERVER_DEADLINE_S)
        burst_s = t_done - t0
        owner_b1 = ck.launches
        # a process acks its last evals before its worker loop reaps
        # their chunk (and counts its waves)
        time.sleep(1.0)
        sup.child_counters()
        children = [child_row(c)
                    for c in srv.stats()["worker_procs"]["children"]]
        rejected = plan_group_stats.snapshot()["rejected_node_plans"]
        grants = (sup.turn.grants if sup.turn is not None else 0) - grants0
        turn_p50, turn_p99 = histograms.get(
            "placement_turn_wait").quantiles((0.5, 0.99))
        e2e = histograms.get("e2e")
        e2e_n = e2e.count
        e2e_p50, e2e_p99 = e2e.quantiles((0.5, 0.99))
        ipc_p99 = histograms.get("worker_ipc").quantiles((0.99,))[0]
        # the server's side of each RPC: the call (the applier's wait
        # included for a plan) and the state frame sent before the reply
        rpc_call_p50 = histograms.get("worker_rpc_call").quantiles((0.5,))[0]
        rpc_sync_p50 = histograms.get("worker_rpc_sync").quantiles((0.5,))[0]
        plan_lat = list(srv.plan_latencies)
        reissues = sup.lease_reissues - reissues0
        check_server_burst(srv, jobs, ctx)
        check(usage_rebuild_diff(srv.state) == [],
              f"{ctx}: usage planes differ from a rebuild")
        busiest = max(sup.handles, key=lambda h: h.child_stats.get(
            "waves", 0))
        busiest.sync_state()
        resident = busiest.probe("resident")
        agents, mask_launches = [], 0
        if system_jobs:
            agents = system_jobs_through(srv, dev, "wp")
            mask_launches = sum(c["mask_launches"]
                                for c in sup.child_counters())
            check(mask_launches >= len(agents), f"{ctx}: {mask_launches} "
                  f"masks for {len(agents)} system evals")
        wp_stats = srv.stats()["worker_procs"]
    finally:
        t0 = time.perf_counter()
        srv.shutdown()
        shutdown_s = time.perf_counter() - t0
    check(leased_generation_count() == 0,
          f"{ctx}: {leased_generation_count()} generation leases after "
          "shutdown")
    check(len(children) == workers and wp_stats["alive"] == workers,
          f"{ctx}: {wp_stats['alive']} of {workers} processes alive")
    check(wp_stats["respawns"] == 0, f"{ctx}: {wp_stats['respawns']} "
          "respawns")
    check(owner_b1 == 0, f"{ctx}: the owner launched B1 {owner_b1} times")
    check(grants >= 1 and sum(c["turn"]["grants"] for c in children)
          == grants, f"{ctx}: {grants} placement turns granted, the "
          f"processes took {[c['turn'] for c in children]}")
    for c in children:
        cc = f"{ctx} process {c['worker_id']}"
        check(c["device"] == card, f"{cc}: device {c['device']}")
        check(c["fused"]["fallbacks"] == 0 and c["fused"]["failures"] == 0,
              f"{cc}: waves fell back or failed: {c['fused']}")
        check(c["device_state_errors"] == 0, f"{cc}: device state errors")
        check(c["b1_launches"] == c["fused"]["launches"] == c["waves"],
              f"{cc}: B1 {c['b1_launches']}, fused {c['fused']}, "
              f"waves {c['waves']}")
        if c["processed"]:
            check(c["b1_launches"] >= 1, f"{cc}: {c['processed']} evals "
                  "and no B1 launch")
    check(resident["resident"] and resident["differ"] == [],
          f"{ctx}: resident planes of process {busiest.worker_id} differ "
          f"from a fresh upload: {resident}")
    check(e2e_n >= SERVER_JOBS, f"{ctx}: {e2e_n} e2e samples")
    b1 = sum(c["b1_launches"] for c in children)
    waves = sum(c["waves"] for c in children)
    return {
        "workers": workers, "cpu_count": os.cpu_count(),
        "restore_s": restore_s, "start_s": start_s, "warmup_s": warmup_s,
        "shutdown_s": shutdown_s, "evals": SERVER_JOBS, "burst_s": burst_s,
        "evals_per_s": SERVER_JOBS / burst_s,
        "e2e_p50_ms": e2e_p50 * 1e3, "e2e_p99_ms": e2e_p99 * 1e3,
        "plan_p50_ms": percentile(plan_lat, 0.5) * 1e3,
        "plan_p99_ms": percentile(plan_lat, 0.99) * 1e3,
        "plans": len(plan_lat), "b1_launches": b1, "waves": waves,
        "wave_fill": (sum(c["wave_fill"] * c["waves"] for c in children)
                      / waves if waves else 0.0),
        "rejected_node_plans": rejected, "turn_grants": grants,
        "turn_wait_p50_ms": turn_p50 * 1e3,
        "turn_wait_p99_ms": turn_p99 * 1e3,
        "lease_reissues": reissues, "worker_ipc_p99_ms": ipc_p99 * 1e3,
        "server_rpc_call_p50_ms": rpc_call_p50 * 1e3,
        "server_rpc_sync_p50_ms": rpc_sync_p50 * 1e3,
        "owner_rss_gb": rss_gb(), "children": children,
        "resident_check": {"worker_id": busiest.worker_id, **resident},
        "system_jobs": agents, "system_mask_launches": mask_launches,
    }


def run_workerproc_phase(dev: torch.device, record: dict,
                         state_bytes: bytes, window_off: dict) -> list:
    """Phase 13: two worker processes with the system jobs, then four;
    phase 11's window-off arm (``window_off``) stands for the arm without
    worker processes."""
    rng = np.random.default_rng(SEED + 13)
    arms = []
    for workers in (2, 4):
        arm = workerproc_arm(dev, state_bytes, workers, rng,
                             system_jobs=workers == 2)
        gc.collect()
        log(f"workerproc: {json.dumps(arm)}")
        arms.append(arm)
    base = {k: window_off[k] for k in (
        "evals_per_s", "e2e_p50_ms", "e2e_p99_ms", "plan_p50_ms",
        "plan_p99_ms", "b1_launches", "waves", "wave_fill", "rss_gb")}
    log(f"workerproc S=0 (phase 11, window off): {json.dumps(base)}")
    record["workerproc"] = {"S0": base, "arms": arms}
    return arms


# ---------------------------------------------------------------------------
# Phase 14: a three-server raft cluster on the card, through a failover.
# ---------------------------------------------------------------------------

RAFT_SERVERS = 3
RAFT_CHILD_TIMEOUT_S = 480.0    # the child process; killed when it is over
RAFT_WAIT_S = 120.0             # an election, a catch-up, a submission
#: the cluster has settled once no leader was won for this long (twice
#: the longest election timeout)
SETTLE_S = 1.2
#: a gap in the stall watch's 5 ms sleep longer than this is a stall
STALL_S = 0.05


#: the header Python prints for a vote thread that an exception ended
VOTE_THREAD_ERROR = re.compile(
    r"^Exception in thread .*\(_request_vote_from\)", re.M)


def run_raft_phase(record: dict, state_bytes: bytes, card: str) -> dict:
    """Phase 14: phase 11's snapshot bytes in a fresh process that runs a
    three-server durable raft cluster through a leader's kill and its
    restart from disk (``raft_cluster_child``). A child, so that the
    server's GC treatment freezes the three stores, their memory and the
    killed server's resident generations go with it."""
    with tempfile.TemporaryDirectory(prefix="raft_cluster_") as tmp:
        state_path = Path(tmp) / "state.bin"
        state_path.write_bytes(state_bytes)
        out = Path(tmp) / "raft.json"
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()),
                 "--raft-cluster", str(state_path), str(out)],
                capture_output=True, text=True,
                timeout=RAFT_CHILD_TIMEOUT_S,
                cwd=str(Path(__file__).resolve().parent))
        except subprocess.TimeoutExpired:
            fail(f"raft cluster: over {RAFT_CHILD_TIMEOUT_S} s")
        for line in proc.stdout.splitlines():
            log(f"raft: {line}")
        check(proc.returncode == 0,
              f"raft cluster failed (exit {proc.returncode}): "
              f"{proc.stderr[-3000:]}")
        res = json.loads(out.read_text())
    # a vote thread that a recovering server's RequestVote handler ended
    # with an exception (ROADMAP C.2, repaired in raft/node)
    res["vote_thread_errors"] = len(VOTE_THREAD_ERROR.findall(proc.stderr))
    res["process_s"] = time.perf_counter() - t0
    res["card"] = card
    log(f"raft: {res['vote_thread_errors']} vote threads ended by an "
        "exception in the child's log")
    log(f"raft: {json.dumps(res)}")
    check(res["vote_thread_errors"] == 0,
          f"raft: {res['vote_thread_errors']} vote threads ended by an "
          "exception")
    record["raft"] = res
    return res


class StallWatch:
    """A thread that sleeps 5 ms at a time and records each wake that
    came more than ``STALL_S`` late: how long something held the
    interpreter lock (a pickle, a restore, a collection) away from every
    thread, the raft timers' included."""

    def __init__(self) -> None:
        self.stalls: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watch")

    def _run(self) -> None:
        last = time.monotonic()
        while not self._stop.wait(0.005):
            now = time.monotonic()
            if now - last - 0.005 > STALL_S:
                self.stalls.append((last, now - last))
            last = now

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def between(self, t0: float, t1: float) -> dict:
        """Stalls that began in [t0, t1): count, longest, total, and the
        five longest as (seconds after t0, seconds)."""
        got = [(t, s) for t, s in self.stalls if t0 <= t < t1]
        top = sorted(got, key=lambda x: -x[1])[:5]
        return {"count": len(got),
                "max_s": max((s for _, s in got), default=0.0),
                "total_s": sum(s for _, s in got),
                "longest": [(round(t - t0, 3), round(s, 3))
                            for t, s in top]}


def leader_wins(events, t0: float, t1: float = float("inf")) -> list:
    return [e for e in events
            if e["kind"] == "leader_won" and t0 <= e["t"] < t1]


def take_worker_errors(servers, events, ctx: str) -> list:
    """The last error of each worker of ``servers``, one line each,
    cleared so that a later gate counts only its own. Each must be on a
    server whose leadership was revoked in ``events``: a deposed
    leader's worker keeps the acks that its flushed broker refused (the
    in-flight batch's evals go back to the new leader from the store);
    an error anywhere else fails."""
    deposed = {e["server"] for e in events if e["kind"] == "revoked"}
    got = []
    for srv in servers:
        for w in srv.workers:
            if not w.last_error:
                continue
            line = w.last_error.strip().splitlines()[-1]
            check(srv.config.name in deposed,
                  f"{ctx}: worker error on {srv.config.name}, whose "
                  f"leadership was not revoked: {line}")
            got.append(f"{srv.config.name}: {line}")
            w.last_error = None
    return got


def track_batches(srv, busy: dict) -> None:
    """``busy[name]`` is true while a worker of ``srv`` holds a batch: from
    a dequeue that handed out evals to the end of that ``run_once``. A
    deposed leader's worker finishes its batch paused, seconds later
    when a stall held the interpreter."""
    name = srv.config.name
    busy[name] = False
    real_dequeue = srv.eval_broker.dequeue_batch

    def dequeue_batch(*args, **kwargs):
        out = real_dequeue(*args, **kwargs)
        if out:
            busy[name] = True
        return out

    srv.eval_broker.dequeue_batch = dequeue_batch
    for w in srv.workers:
        def run_once(timeout=0.0, real=w.run_once):
            try:
                return real(timeout)
            finally:
                busy[name] = False

        w.run_once = run_once


def quiesce(servers, raft_observer, busy: dict, ctx: str):
    """Settle, then wait until no worker holds a batch and the leader's
    broker is empty, with no leader won meanwhile; returns the
    leader."""
    deadline = time.monotonic() + RAFT_WAIT_S
    while True:
        leader = settle(servers, raft_observer, ctx)
        t0 = time.monotonic()
        while True:
            bs = leader.eval_broker.stats()
            if not any(busy.values()) and bs["total_ready"] \
                    == bs["total_unacked"] == bs["total_waiting"] == 0:
                break
            check(time.monotonic() < deadline,
                  f"{ctx}: workers still busy {busy}, leader's broker {bs}")
            time.sleep(0.01)
        if not leader_wins(raft_observer.events(t0), t0):
            return leader


def settle(servers, raft_observer, ctx: str):
    """Wait until one server leads and no leader was won for
    ``SETTLE_S`` (a stall that expired every timer may still be electing
    when the first leader shows); returns the leader."""
    from nomad_tpu_torch.server.testing import wait_for_leader

    deadline = time.monotonic() + RAFT_WAIT_S
    while True:
        leader = wait_for_leader(servers, timeout=RAFT_WAIT_S)
        now = time.monotonic()
        if not leader_wins(raft_observer.events(now - SETTLE_S),
                           now - SETTLE_S):
            return leader
        check(now < deadline, f"{ctx}: leadership did not settle")
        time.sleep(0.05)


def store_rows(srv) -> tuple:
    """The store's index and ``alloc id -> (node, desired, client
    status)``."""
    snap = srv.state.snapshot()
    return srv.state.latest_index(), {
        a.id: (a.node_id, a.desired_status, a.client_status)
        for a in snap.allocs_iter()}


def resident_bytes(uid: str = "") -> tuple:
    """(generations, bytes) resident in the process's device state; with
    ``uid``, only the generations of that store's usage."""
    gens = [g for k, g in list(default_device_state._gens.items())
            if not uid or k[0] == uid]
    return len(gens), sum(t.numel() * t.element_size()
                          for g in gens for t in g.planes.values())


def raft_cluster_child(state_path: str, out_path: str,
                       device: str = "cuda") -> int:
    """Phase 14 in its own process. Three servers on ``device`` (the card;
    a rehearsal on the CPU names ``cpu``), each store restored from
    phase 11's snapshot bytes before ``start()``, each with its own data
    dir (WAL, stable store, snapshots; ``raft_fsync_policy="batch"``),
    over the in-memory transport with ``CLUSTER_RAFT_CONFIG``'s timers.
    Once a leader is up, every node writes a snapshot of that state to
    its data dir. Then the 40 warm-up jobs, then the timed burst of 200:
    a thread registers them with whichever server leads; when half are
    placed the leader is killed (``hard_kill``), the burst converges on
    the two survivors, and the killed server is restarted from its data
    dir until it has applied the leader's commit index. The result goes
    to ``out_path`` as JSON."""
    import copy

    from nomad_tpu_torch.raft.observe import raft_observer
    from nomad_tpu_torch.raft.transport import (
        InmemTransport,
        TransportRegistry,
    )
    from nomad_tpu_torch.raft.wal import wal_stats
    from nomad_tpu_torch.server.testing import (
        CLUSTER_RAFT_CONFIG,
        hard_kill,
        restart_server,
        wait_for_leader,
    )
    from nomad_tpu_torch.state.usage import usage_rebuild_diff
    from nomad_tpu_torch.telemetry.histogram import (
        RAFT_APPEND,
        RAFT_QUORUM,
        WAL_FSYNC,
    )
    from nomad_tpu_torch.telemetry.timeline import (
        build_timeline,
        validate_timeline,
    )

    dev = torch.device(device)
    check(dev.type != "cuda" or torch.cuda.is_available(),
          "raft cluster: no CUDA card")
    ctx = "raft cluster"
    t_phase = time.monotonic()
    # the servers warm nothing: no manifest outside this run may be read
    kernel_warmup.DEFAULT_MANIFEST_PATH = str(
        Path(__file__).resolve().parent / "build" / "no_manifest.json")
    thread_errors: list = []
    default_hook = threading.excepthook

    def count_thread_error(args) -> None:
        thread_errors.append(f"{args.thread.name if args.thread else '?'}: "
                             f"{args.exc_type.__name__}: {args.exc_value}")
        default_hook(args)

    threading.excepthook = count_thread_error
    if dev.type == "cuda":
        # the context and the kernels' libraries, before any server runs:
        # either holds the interpreter lock for a while on first use
        torch.zeros(1, device=dev)
        ck.load_libraries()
    stall = StallWatch()
    stall.start()
    state_bytes = Path(state_path).read_bytes()
    cfg = ServerConfig(num_workers=1, worker_batch_size=SERVER_BATCH,
                       heartbeat_ttl=3600.0, coalesce_adaptive=False,
                       device=device)
    check(cfg.raft_fsync_policy == "batch",
          f"{ctx}: fsync policy {cfg.raft_fsync_policy}")
    registry = TransportRegistry()
    addrs = [f"server-{i}" for i in range(RAFT_SERVERS)]
    servers: list = []
    busy: dict = {}
    res: dict = {"servers": RAFT_SERVERS, "device": str(dev)}
    with tempfile.TemporaryDirectory(prefix="raft_data_") as data:
        try:
            # ---- build: each store seeded before start() ----
            restore_s = []
            for addr in addrs:
                c = copy.deepcopy(cfg)
                c.name = addr
                c.data_dir = os.path.join(data, addr)
                srv = Server(c)
                t0 = time.monotonic()
                srv.state.restore_from_bytes(state_bytes)
                restore_s.append(time.monotonic() - t0)
                srv.setup_raft(node_id=addr, peers=addrs,
                               transport=InmemTransport(addr, registry),
                               raft_config=CLUSTER_RAFT_CONFIG)
                track_batches(srv, busy)
                servers.append(srv)
            del state_bytes
            t_start = time.monotonic()
            for srv in servers:
                srv.start()
            leader = wait_for_leader(servers, timeout=RAFT_WAIT_S)
            elect_s = time.monotonic() - t_start
            snapshot_s = []
            for srv in servers:
                t0 = time.monotonic()
                srv.raft.force_snapshot()
                snapshot_s.append(time.monotonic() - t0)
            # phase 10's evals are still pending in the state (its harness
            # records eval updates, not the store's rows): each leader
            # restores them into its broker, so one deposed by the
            # snapshots' stalls may keep errors from its last batch
            leader = quiesce(servers, raft_observer, busy, ctx)
            t_seeded = time.monotonic()
            seeding_wins = leader_wins(raft_observer.events(t_start),
                                       t_start)
            res.update({
                "restore_s": restore_s, "first_election_s": elect_s,
                "force_snapshot_s": snapshot_s,
                "snapshot_index": [s.raft.log.base_index() for s in servers],
                "seeding_leader_wins": len(seeding_wins),
                "seeding_stalls": stall.between(t_start, t_seeded),
                "seeding_worker_errors": take_worker_errors(
                    servers, raft_observer.events(t_start), ctx),
            })
            log(f"seeded: restores {[round(s, 2) for s in restore_s]} s, "
                f"snapshots {[round(s, 2) for s in snapshot_s]} s, "
                f"{len(seeding_wins)} leader wins, stalls "
                f"{res['seeding_stalls']}, "
                f"{len(res['seeding_worker_errors'])} worker errors")

            # ---- warm-up ----
            rng = np.random.default_rng(SEED + 14)
            warm = [c2m.burst_job(rng, i, prefix="raft-warm")
                    for i in range(SERVER_WARMUP_JOBS)]
            t0 = time.monotonic()
            for job in warm:
                leader.job_register(job)
            leader = wait_for_leader(servers, timeout=RAFT_WAIT_S)
            server_converged(leader, warm, time.time() + SERVER_DEADLINE_S)
            t1 = time.monotonic()
            warm_wins = leader_wins(raft_observer.events(t0), t0)
            res.update({"warmup_s": t1 - t0,
                        "warmup_leader_wins": len(warm_wins),
                        "warmup_stalls": stall.between(t0, t1)})
            if warm_wins:
                # a leadership change in the warm-up is counted, not
                # failed
                log(f"warm-up: {len(warm_wins)} leader wins, stalls "
                    f"{res['warmup_stalls']}")
                leader = quiesce(servers, raft_observer, busy, ctx)
                res["warmup_worker_errors"] = take_worker_errors(
                    servers, raft_observer.events(t_start), ctx)
            check_server_burst(leader, warm, f"{ctx} warm-up")

            # ---- the timed burst, through the kill ----
            leader = quiesce(servers, raft_observer, busy, ctx)
            res["pre_burst_worker_errors"] = take_worker_errors(
                servers, raft_observer.events(t_start), ctx)
            jobs = [c2m.burst_job(rng, i, prefix="raft-burst")
                    for i in range(SERVER_JOBS)]
            for name in ("e2e", WAL_FSYNC, RAFT_QUORUM, RAFT_APPEND):
                histograms.get(name).reset()
            for srv in servers:
                srv.plan_latencies.clear()
            plan_group_stats.reset()
            coalesce.fused_wave_stats.reset()
            coalesce.wave_stats.reset()
            coalesce.upload_stats.reset()
            default_device_state.reset_stats()
            wal_stats.reset_stats()
            first = leader
            killed_uid = first.state.snapshot().usage.uid
            waves0 = {s.config.name: s.workers[0].batch_launches
                      for s in servers}
            waves: list = []        # (start, end) of each launch_wave
            requested: list = []
            real_launch = coalesce.launch_wave
            real_request = default_device_state.request

            def timed_launch(*args, **kwargs):
                t = time.monotonic()
                out = real_launch(*args, **kwargs)
                waves.append((t, time.monotonic()))
                return out

            def noted_request(cluster, usage, device):
                requested.append((time.monotonic(),
                                  getattr(usage, "uid", "")))
                return real_request(cluster, usage, device)

            coalesce.launch_wave = timed_launch
            default_device_state.request = noted_request
            alive = list(servers)
            submit_errors: list = []
            # the kill lands between two registrations: one in flight on
            # a dead leader would wait out its apply's 10 s timeout
            submit_lock = threading.Lock()

            def submitter() -> None:
                for job in jobs:
                    deadline = time.monotonic() + RAFT_WAIT_S
                    while True:
                        with submit_lock:
                            srv = next((s for s in alive if s.raft.is_leader()
                                        and s.is_leader()), None)
                            try:
                                if srv is not None:
                                    srv.job_register(job)
                                    break
                            except Exception as e:      # noqa: BLE001
                                submit_errors.append(repr(e)[:200])
                        if time.monotonic() > deadline:
                            submit_errors.append(f"no leader took {job.id}")
                            return
                        time.sleep(0.005)

            def placed_jobs(srv) -> int:
                snap = srv.state.snapshot()
                return sum(len(snap.allocs_by_job(j.namespace, j.id))
                           >= c2m.BURST_COUNT for j in jobs)

            pauses = GcPauses()
            gc.callbacks.append(pauses)
            ck.launches = 0
            most_leaders = 0
            t_burst = time.monotonic()
            sub = threading.Thread(target=submitter, name="submitter")
            sub.start()
            deadline = time.monotonic() + SERVER_DEADLINE_S
            while placed_jobs(first) < SERVER_JOBS // 2:
                check(time.monotonic() < deadline,
                      f"{ctx}: half the burst not placed by its deadline")
                most_leaders = max(most_leaders, sum(
                    s.raft.is_leader() for s in alive))
                time.sleep(0.01)
            with submit_lock:
                placed_at_kill = placed_jobs(first)
                submitted_at_kill = sum(1 for j in jobs if first.state
                                        .snapshot().job_by_id(j.namespace,
                                                              j.id))
                alive.remove(first)
                t_kill = time.monotonic()
                hard_kill(first)
                t_killed = time.monotonic()
            first_b1 = ck.launches
            first_waves = first.workers[0].batch_launches \
                - waves0[first.config.name]
            new = wait_for_leader(alive, timeout=RAFT_WAIT_S)
            while sub.is_alive():
                most_leaders = max(most_leaders, sum(
                    s.raft.is_leader() for s in alive))
                sub.join(0.01)
            server_converged(new, jobs, time.time() + SERVER_DEADLINE_S)
            t_conv = time.monotonic()
            gc.callbacks.remove(pauses)
            coalesce.launch_wave = real_launch
            default_device_state.request = real_request
            check(not any("no leader took" in e for e in submit_errors),
                  f"{ctx}: submissions failed: {submit_errors[-3:]}")
            new_b1 = ck.launches - first_b1
            new_waves = new.workers[0].batch_launches \
                - waves0[new.config.name]
            fstats = coalesce.fused_wave_stats.snapshot()
            gens_after, bytes_after = resident_bytes()
            killed_gens, killed_bytes = resident_bytes(killed_uid)
            e2e = histograms.get("e2e")
            e2e_n = e2e.count
            e2e_p50, e2e_p99 = e2e.quantiles((0.5, 0.99))
            fsync_p50, fsync_p99 = histograms.get(WAL_FSYNC).quantiles(
                (0.5, 0.99))
            quorum_p50, quorum_p99 = histograms.get(RAFT_QUORUM).quantiles(
                (0.5, 0.99))
            append_p50, append_p99 = histograms.get(RAFT_APPEND).quantiles(
                (0.5, 0.99))
            wal = wal_stats.snapshot()
            plan_lat = list(first.plan_latencies) + list(new.plan_latencies)
            dstate = default_device_state.snapshot()
            events = raft_observer.events(t_burst)
            timeline = build_timeline(events, converged_mono=t_conv,
                                      cell="phase14-raft-c2m")
            problems = validate_timeline(timeline)
            wins = leader_wins(events, t_burst, t_conv)
            est = [e for e in events if e["kind"] == "established"
                   and e["server"] == new.raft.id and e["t"] >= t_kill]
            new_waves_t = [w for w in waves if w[0] > t_killed]
            old_waves_s = [b - a for a, b in waves if b <= t_kill]
            burst_stalls = stall.between(t_burst, t_conv)

            # ---- the gates of the burst ----
            check(len(wins) == 1 and wins[0]["server"] == new.raft.id
                  and wins[0]["t"] > t_kill,
                  f"{ctx}: leadership changed in the timed burst other than "
                  f"by the kill: {[(e['server'], e['term'], round(e['t'] - t_burst, 3)) for e in wins]}; "
                  f"stalls {burst_stalls}, gc {pauses.full} full "
                  f"collections, {pauses.seconds:.3f} s")
            check(most_leaders <= 1,
                  f"{ctx}: {most_leaders} servers led at once")
            check(fstats["fallbacks"] == 0 and fstats["failures"] == 0,
                  f"{ctx}: waves fell back or failed: {fstats}")
            check(ck.launches == fstats["launches"],
                  f"{ctx}: B1 launches {ck.launches} != fused {fstats}")
            check(first_b1 >= 1 and new_b1 >= 1,
                  f"{ctx}: B1 launches: first leader {first_b1}, new "
                  f"leader {new_b1}")
            new_uid = new.state.snapshot().usage.uid
            check(killed_uid != new_uid,
                  f"{ctx}: the new leader's store has the killed uid")
            check(est and new_waves_t,
                  f"{ctx}: the new leader established {len(est)} times, "
                  f"ran {len(new_waves_t)} waves")
            # once the new leader is established every request for planes
            # is its waves' (the killed server's last evals ask while it
            # shuts down), and each names the new leader's store
            after = [u for t, u in requested if t >= est[0]["t"]]
            check(after and all(u == new_uid for u in after),
                  f"{ctx}: {sum(u != new_uid for u in after)} of "
                  f"{len(after)} requests after the new leader was "
                  "established name another store")
            check(dstate["errors"] == 0,
                  f"{ctx}: device state errors: {dstate}")
            check(e2e_n >= SERVER_JOBS, f"{ctx}: {e2e_n} e2e samples")
            check_server_burst(new, jobs, ctx)
            snap = new.state.snapshot()
            for job in jobs:
                names = [a.name for a in snap.allocs_by_job(
                    job.namespace, job.id) if not a.terminal_status()]
                check(len(set(names)) == len(names) == c2m.BURST_COUNT,
                      f"{ctx}: job {job.id} allocs by name {sorted(names)}")
            resident = check_resident(new, dev, ctx)
            check(not problems, f"{ctx}: failover timeline: {problems}")
            fos = timeline["failovers"]
            check(len(fos) == 1 and fos[0]["resolved"]
                  and fos[0]["leader_from"] == first.raft.id,
                  f"{ctx}: failovers {fos}")
            res.update({
                "evals": SERVER_JOBS, "placed_at_kill": placed_at_kill,
                "submitted_at_kill": submitted_at_kill,
                "burst_s": t_conv - t_burst,
                "evals_per_s_before_kill": placed_at_kill
                / (t_kill - t_burst),
                "evals_per_s_after_kill": (SERVER_JOBS - placed_at_kill)
                / (t_conv - t_kill),
                "evals_per_s_after_first_new_wave": (
                    (SERVER_JOBS - placed_at_kill)
                    / max(t_conv - new_waves_t[0][1], 1e-9)),
                "e2e_samples": e2e_n,
                "e2e_p50_ms": e2e_p50 * 1e3, "e2e_p99_ms": e2e_p99 * 1e3,
                "plan_p50_ms": percentile(plan_lat, 0.5) * 1e3,
                "plan_p99_ms": percentile(plan_lat, 0.99) * 1e3,
                "plans": len(plan_lat),
                "wal_fsync_p50_ms": fsync_p50 * 1e3,
                "wal_fsync_p99_ms": fsync_p99 * 1e3,
                "wal_fsyncs": wal["fsyncs"], "wal_frames": wal["frames"],
                "entries_per_fsync": (wal["frames"] / wal["fsyncs"]
                                      if wal["fsyncs"] else 0.0),
                "wal_per_server": {k: v.get("fsync_batch_avg")
                                   for k, v in wal_stats.per_server().items()},
                "raft_quorum_p50_ms": quorum_p50 * 1e3,
                "raft_quorum_p99_ms": quorum_p99 * 1e3,
                "raft_append_p50_ms": append_p50 * 1e3,
                "raft_append_p99_ms": append_p99 * 1e3,
                "failover": {
                    "kill_s": t_killed - t_kill,
                    "to_leader_won_s": wins[0]["t"] - t_kill,
                    "to_established_s": est[0]["t"] - t_kill,
                    "to_first_new_wave_end_s": new_waves_t[0][1] - t_kill,
                    "to_converged_s": t_conv - t_kill,
                    "phases_ms": fos[0]["phases_ms"],
                    "total_ms": fos[0]["total_ms"],
                    "attributed_share": fos[0]["attributed_share"],
                },
                "first_leader": first.raft.id, "new_leader": new.raft.id,
                "b1_launches_first": first_b1, "b1_launches_new": new_b1,
                "b1_launches": ck.launches,
                "waves_first": first_waves, "waves_new": new_waves,
                "wave_latency_p50_ms":
                    coalesce.wave_stats.snapshot()["wave_latency_p50_ms"],
                # launch_wave: assembly, uploads, B1 and the readback
                "first_new_wave_ms":
                    (new_waves_t[0][1] - new_waves_t[0][0]) * 1e3,
                "first_leader_wave_p50_ms":
                    percentile(old_waves_s, 0.5) * 1e3,
                "fallbacks": fstats["fallbacks"],
                "killed_store_requests_in_kill": sum(
                    u == killed_uid for t, u in requested
                    if t_kill < t < est[0]["t"]),
                "requests_after_established": len(after),
                "submit_retries": len(submit_errors),
                "device_state": dstate,
                "resident_generations_after_kill": gens_after,
                "resident_bytes_after_kill": bytes_after,
                "killed_generations": killed_gens,
                "killed_resident_bytes": killed_bytes,
                "resident_check": resident,
                "burst_stalls": burst_stalls,
                "gc_full": pauses.full, "gc_s": pauses.seconds,
                "group_commits": plan_group_stats.snapshot()["commit_batches"],
                "rejected_node_plans":
                    plan_group_stats.snapshot()["rejected_node_plans"],
                "timeline_events": len(timeline["events"]),
            })
            log(f"burst: {placed_at_kill} of {SERVER_JOBS} jobs placed at "
                f"the kill; B1 {first_b1} + {new_b1}; new leader "
                f"{new.raft.id} won {wins[0]['t'] - t_kill:.3f} s after it")

            # ---- restart from disk ----
            t0 = time.monotonic()
            fresh = restart_server(first, registry,
                                   raft_config=CLUSTER_RAFT_CONFIG)
            recover_s = time.monotonic() - t0
            servers[servers.index(first)] = fresh
            del first
            target = new.raft.commit_index
            deadline = time.monotonic() + RAFT_WAIT_S
            while fresh.raft.last_applied < target:
                check(time.monotonic() < deadline,
                      f"{ctx}: the restarted server applied "
                      f"{fresh.raft.last_applied} of {target} (its commit "
                      f"{fresh.raft.commit_index}, log "
                      f"{fresh.raft.log.base_index()}-"
                      f"{fresh.raft.log.last_index()}, term "
                      f"{fresh.raft.current_term}, leader "
                      f"{fresh.raft.leader_id}; the leader's next index for "
                      f"it {new.raft.next_index.get(fresh.raft.id)}, match "
                      f"{new.raft.match_index.get(fresh.raft.id)}); thread "
                      f"errors {thread_errors[:3]}")
                time.sleep(0.01)
            catch_up_s = time.monotonic() - t0 - recover_s
            deadline = time.monotonic() + RAFT_WAIT_S
            while True:
                rows = [store_rows(s) for s in servers]
                if all(r == rows[0] for r in rows[1:]):
                    break
                check(time.monotonic() < deadline,
                      f"{ctx}: stores differ after the restart: "
                      f"{[(r[0], len(r[1])) for r in rows]}")
                time.sleep(0.1)
            t_equal = time.monotonic()
            for srv in servers:
                check(usage_rebuild_diff(srv.state) == [],
                      f"{ctx}: {srv.config.name}'s usage planes differ "
                      "from a rebuild")
            restart_wins = leader_wins(raft_observer.events(t0), t0)
            check(fresh.raft.recovered_snapshot_index > 0,
                  f"{ctx}: the restart recovered no snapshot")
            res["restart"] = {
                "server": fresh.raft.id,
                "snapshot_index": fresh.raft.recovered_snapshot_index,
                "replayed_entries": fresh.raft.replayed_entries,
                "recover_s": recover_s, "catch_up_s": catch_up_s,
                "stores_equal_s": t_equal - t0,
                "index": rows[0][0], "allocs": len(rows[0][1]),
                "leader_wins": len(restart_wins),
                "stalls": stall.between(t0, t_equal),
            }
            res["rss_gb"] = rss_gb()
            log(f"restart: {json.dumps(res['restart'])}")
        finally:
            for srv in servers:
                try:
                    srv.shutdown()
                except Exception as e:                  # noqa: BLE001
                    log(f"shutdown of {srv.config.name}: {e!r}")
            stall.stop()
            threading.excepthook = default_hook
    res["thread_errors"] = thread_errors[:10]
    res["thread_error_count"] = len(thread_errors)
    res["phase_s"] = time.monotonic() - t_phase
    Path(out_path).write_text(json.dumps(res))
    return 0


# ---------------------------------------------------------------------------
# Phase 15: the agent on the card, over its HTTP API and its CLI.
# ---------------------------------------------------------------------------

AGENT_START_S = 180.0       # the child's start, up to its "HTTP at" line
AGENT_DEADLINE_S = 120.0    # per burst; a burst that takes longer fails
AGENT_STOP_S = 30.0         # SIGTERM to exit
AGENT_CLIENTS = 8           # threads submitting a burst, one client each
AGENT_TRACED_JOBS = 40
AGENT_POLL_S = 0.005
#: the agent's config file. ``worker_batch_size`` and ``num_schedulers``
#: give the agent phase 11's server shape (one worker, batches of 32);
#: the window is off for the reason phase 11's third arm turns it off;
#: no warmup manifest is read or written
AGENT_CONFIG = """
bind_addr = "127.0.0.1"
server {
  enabled           = true
  num_schedulers    = 1
  worker_batch_size = %d
  coalesce_adaptive = false
  kernel_warmup     = false
}
"""
#: the job ``job run`` submits: a lean C2M ask, 10 placements
AGENT_CLI_JOB = """
job "%s" {
  datacenters = [%s]
  type        = "service"
  group "web" {
    count = %d
    task "app" {
      driver = "mock_driver"
      resources {
        cpu    = 250
        memory = 256
      }
    }
  }
}
"""


class AgentChild:
    """``python -m nomad_tpu_torch agent -config <file> -http-port 0`` as
    a child process: its stdout is read on a thread (the ``HTTP at``
    line gives the address), its stderr goes to a file."""

    def __init__(self, config_path: str, log_path: str,
                 device: str = "", flags: tuple = (),
                 env: dict = None) -> None:
        argv = [sys.executable, "-m", "nomad_tpu_torch", "agent", *flags,
                "-config", config_path, "-http-port", "0"]
        if device:
            argv += ["-device", device]
        self._err = open(log_path, "w")
        self.log_path = log_path
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=self._err, text=True,
            cwd=str(Path(__file__).resolve().parent),
            env={**os.environ, **(env or {})})
        self.lines: list = []
        self.addr = ""
        self.t_caught = 0.0
        self._ready = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name="agent-stdout")
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            line = line.rstrip("\n")
            self.lines.append(line)
            if "Caught signal" in line:
                self.t_caught = time.perf_counter()
            if "HTTP at " in line and not self.addr:
                self.addr = line.split("HTTP at ", 1)[1].strip()
                self._ready.set()
        self._ready.set()

    def wait_ready(self, timeout: float) -> str:
        self._ready.wait(timeout)
        check(bool(self.addr),
              f"agent did not start in {timeout} s (exit "
              f"{self.proc.poll()}): {self.lines[-5:]} {self.stderr()}")
        return self.addr

    def stderr(self) -> str:
        if not self._err.closed:
            self._err.flush()
        return Path(self.log_path).read_text()[-3000:]

    def rss_gb(self) -> float:
        status = Path(f"/proc/{self.proc.pid}/status").read_text()
        for line in status.splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
        return 0.0

    def terminate(self) -> None:
        """SIGTERM: the agent shuts down and exits."""
        self.t_term = time.perf_counter()
        self.proc.terminate()

    def wait_exit(self, timeout: float) -> dict:
        """The exit code after ``terminate`` (None when it took longer
        than ``timeout`` and was killed), the seconds to its exit, and of
        them the seconds from its "Caught signal" line on (the agent's
        shutdown and the interpreter's exit)."""
        try:
            rc = self.proc.wait(max(timeout - (time.perf_counter()
                                               - self.t_term), 0.0))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            rc = None
        t_exit = time.perf_counter()
        self._reader.join(5.0)
        self._err.close()
        return {"rc": rc, "stop_s": t_exit - self.t_term,
                "after_signal_line_s": t_exit - self.t_caught
                if self.t_caught else None}

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self._err.closed:
            self._err.close()


def prometheus_values(text: str) -> dict:
    """The scrape's samples as ``{"name{labels}": value}``."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def scrape(addr: str) -> dict:
    import urllib.request

    with urllib.request.urlopen(
            f"{addr}/v1/metrics?format=prometheus", timeout=60) as r:
        return prometheus_values(r.read().decode())


def agent_idle(api) -> dict:
    """The broker and blocked-eval counters of ``/v1/agent/self``."""
    stats = api.agent.self()["Stats"]["nomad"]
    return {"broker": stats["broker"], "blocked": stats["blocked"]}


def agent_burst(addr: str, jobs, deadline: float, ctx: str) -> dict:
    """Register ``jobs`` over HTTP (``PUT /v1/jobs``) from
    ``AGENT_CLIENTS`` threads, each with its own ``APIClient``, then poll
    the broker until it is empty with nothing unacked: the host clock at
    that moment ends the burst. Returns the register latencies, the eval
    ids, each registration's wall-clock return (``registered_at``, in
    the jobs' order) and the burst's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from nomad_tpu_torch.api.client import APIClient
    from nomad_tpu_torch.api.codec import encode

    local = threading.local()
    wires = [encode(job) for job in jobs]

    def register(wire) -> tuple:
        api = getattr(local, "api", None)
        if api is None:
            api = local.api = APIClient(addr)
        t = time.perf_counter()
        res = api.jobs.register(wire)
        return time.perf_counter() - t, res["EvalID"], time.time()

    api = APIClient(addr)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(AGENT_CLIENTS) as ex:
        out = list(ex.map(register, wires))
    t_sent = time.perf_counter()
    while time.time() < deadline:
        idle = agent_idle(api)
        b = idle["broker"]
        if b["total_ready"] == b["total_unacked"] == b["total_waiting"] == 0:
            break
        time.sleep(AGENT_POLL_S)
    else:
        fail(f"{ctx}: burst of {len(jobs)} did not converge: "
             f"{agent_idle(api)}")
    t_done = time.perf_counter()
    lats = [lat for lat, _, _ in out]
    return {"jobs": len(jobs), "burst_s": t_done - t0,
            "send_s": t_sent - t0,
            "evals_per_s": len(jobs) / (t_done - t0),
            "register_p50_ms": percentile(lats, 0.5) * 1e3,
            "register_p99_ms": percentile(lats, 0.99) * 1e3,
            "eval_ids": [eid for _, eid, _ in out],
            "registered_at": [at for _, _, at in out],
            "blocked": idle["blocked"]}


def span_from_api(row: dict):
    """A ``/v1/operator/traces`` span row as the tracer's ``Span``."""
    from nomad_tpu_torch.telemetry.trace import Span

    dur = row["DurationMs"] / 1e3
    cpu = row["CpuMs"] / 1e3
    return Span(row["Name"], row["TraceID"], row["SpanID"], row["ParentID"],
                row["Start"], dur, dur - row["ExclusiveMs"] / 1e3, cpu,
                cpu - row["ExclusiveCpuMs"] / 1e3, row["Thread"])


def span_table(rows: list) -> dict:
    """Per span name: count, and its exclusive wall and CPU p50/p99."""
    by: dict = {}
    for r in rows:
        by.setdefault(r["Name"], []).append(r)
    return {name: {
        "count": len(rs),
        "excl_p50_ms": percentile([r["ExclusiveMs"] for r in rs], 0.5),
        "excl_p99_ms": percentile([r["ExclusiveMs"] for r in rs], 0.99),
        "excl_cpu_p50_ms": percentile(
            [r["ExclusiveCpuMs"] for r in rs], 0.5),
        "excl_cpu_p99_ms": percentile(
            [r["ExclusiveCpuMs"] for r in rs], 0.99)}
        for name, rs in sorted(by.items())}


def check_agent_store(state, jobs, eval_ids, dev, ctx: str) -> dict:
    """Every job with its allocations live and unique by name, none of
    the bursts' evals failed, no node over capacity."""
    from nomad_tpu_torch.parallel.coalesce import ClusterCache

    snap = state.snapshot()
    for ns, job_id, count in jobs:
        live = [a for a in snap.allocs_by_job(ns, job_id)
                if not a.terminal_status()]
        names = {a.name for a in live}
        check(len(live) == count and len(names) == count,
              f"{ctx}: job {job_id} has {len(live)} live allocs, "
              f"{len(names)} names")
    failed = [eid for eid in eval_ids
              if snap.eval_by_id(eid) is not None
              and snap.eval_by_id(eid).status == consts.EVAL_STATUS_FAILED]
    check(not failed, f"{ctx}: {len(failed)} failed evals")
    missing = [eid for eid in eval_ids if snap.eval_by_id(eid) is None]
    check(not missing, f"{ctx}: {len(missing)} evals not in the store")
    over = store_over_capacity(state, ClusterCache(dev))
    check(over == 0, f"{ctx}: {over} nodes over capacity")
    pending = sum(1 for e in snap.evals_iter()
                  if e.status == consts.EVAL_STATUS_PENDING)
    return {"jobs": len(jobs), "evals": len(eval_ids),
            "pending_evals_not_ours": pending}


def operator_archive(state_bytes: bytes) -> tuple:
    """A store's snapshot bytes as an operator snapshot archive (the
    port's ``utils/snapshot`` format, what ``GET /v1/operator/snapshot``
    gives), and the number of its nodes."""
    from types import SimpleNamespace

    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.utils.snapshot import archive_snapshot

    src = StateStore()
    src.restore_from_bytes(state_bytes)
    n_nodes = sum(1 for _ in src.snapshot().nodes())
    return archive_snapshot(SimpleNamespace(state=src, raft=None)), n_nodes


def run_agent_phase(dev: torch.device, record: dict, state_bytes: bytes,
                    window_off: dict, card: str, device: str = "") -> dict:
    """Phase 15: the agent in a child process, on the card unless
    ``device`` names another, driven only over its HTTP API and its
    CLI."""
    import base64
    from concurrent.futures import ThreadPoolExecutor

    from nomad_tpu_torch.api.client import APIClient
    from nomad_tpu_torch.api.codec import encode
    from nomad_tpu_torch.state.store import StateStore
    from nomad_tpu_torch.telemetry.waterfall import (
        aggregate_tail,
        build_waterfalls,
    )
    from nomad_tpu_torch.utils.snapshot import read_snapshot

    ctx = "agent"
    t_phase = time.perf_counter()
    res: dict = {"card": card, "clients": AGENT_CLIENTS,
                 "worker_batch_size": SERVER_BATCH}
    rng = np.random.default_rng(SEED + 15)
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(prefix="agent_") as tmp:
        cfg = Path(tmp) / "agent.hcl"
        cfg.write_text(AGENT_CONFIG % SERVER_BATCH)
        t0 = time.perf_counter()
        child = AgentChild(str(cfg), str(Path(tmp) / "agent.log"), device)
        pool = ThreadPoolExecutor(1)
        try:
            # the archive is made while the agent starts
            archiving = pool.submit(operator_archive, state_bytes)
            addr = child.wait_ready(AGENT_START_S)
            res["start_s"] = time.perf_counter() - t0
            api = APIClient(addr)

            # -- restore phase 11's state as an operator snapshot --------
            archive, n_nodes = archiving.result()
            res["archive_s"] = time.perf_counter() - t0
            res["archive_mb"] = len(archive) / 1e6
            body = base64.b64encode(archive).decode()
            res["body_mb"] = len(body) / 1e6
            t0 = time.perf_counter()
            api.put("/v1/operator/snapshot", {"Snapshot": body})
            res["restore_s"] = time.perf_counter() - t0
            del archive, body
            nodes = api.nodes.list()
            ready = sum(1 for n in nodes if n["Status"] == "ready")
            check(len(nodes) == n_nodes and ready == n_nodes,
                  f"{ctx}: restored {len(nodes)} nodes, {ready} ready, "
                  f"want {n_nodes}")
            res["nodes"] = ready

            # -- warm-up, then the timed burst with every count at 0 -----
            warm = [c2m.burst_job(rng, i, prefix="agent-warm")
                    for i in range(SERVER_WARMUP_JOBS)]
            res["warmup"] = agent_burst(
                addr, warm, time.time() + AGENT_DEADLINE_S,
                f"{ctx} warm-up")
            api.put("/v1/operator/traces", {"Reset": True})
            before = scrape(addr)
            jobs = [c2m.burst_job(rng, i, prefix="agent-burst")
                    for i in range(SERVER_JOBS)]
            burst = agent_burst(addr, jobs, time.time() + AGENT_DEADLINE_S,
                                f"{ctx} burst")
            after = scrape(addr)
            hist = api.get("/v1/operator/slow-evals")["Histogram"]
            res["burst"] = {k: v for k, v in burst.items()
                            if k not in ("eval_ids", "registered_at")}
            delta = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in (
                "nomad_tpu_wave_fused_launches_total",
                "nomad_tpu_wave_fused_fallbacks_total",
                "nomad_tpu_wave_fused_failures_total",
                "nomad_tpu_device_state_errors_total",
                'nomad_tpu_wave_launches_total{fired="full"}',
                'nomad_tpu_wave_launches_total{fired="deadline"}')}
            res["scrape"] = delta
            res["agent_launches"] = int(
                delta["nomad_tpu_wave_fused_launches_total"])
            waves = (delta['nomad_tpu_wave_launches_total{fired="full"}']
                     + delta['nomad_tpu_wave_launches_total'
                             '{fired="deadline"}'])
            res["waves"] = int(waves)
            # evals per wave, as phase 11 counts fill; the scrape's ratio
            # is members over the coalescer's slots
            res["evals_per_wave"] = len(jobs) / waves if waves else 0.0
            res["wave_fill_ratio"] = after["nomad_tpu_wave_fill_ratio"]
            res["evals_per_s"] = burst["evals_per_s"]
            res["latency"] = {name: hist[name] for name in (
                "e2e", "plan_queue", "plan_evaluate", "plan_commit",
                "snapshot_wait") if name in hist}
            e2e = hist.get("e2e", {})
            res["e2e_p50_ms"] = e2e.get("p50_ms")
            res["e2e_p99_ms"] = e2e.get("p99_ms")
            check(res["agent_launches"] > 0,
                  f"{ctx}: no B1 launch in the timed burst: {delta}")
            check(delta["nomad_tpu_wave_fused_fallbacks_total"] == 0
                  and delta["nomad_tpu_wave_fused_failures_total"] == 0,
                  f"{ctx}: waves fell back or failed: {delta}")
            check(delta["nomad_tpu_device_state_errors_total"] == 0,
                  f"{ctx}: device state errors: {delta}")
            check(e2e.get("count", 0) >= len(jobs),
                  f"{ctx}: {e2e.get('count')} e2e samples")

            # -- the CLI: job run, job status ----------------------------
            dcs = ", ".join(f'"dc{d}"' for d in range(1, 11))
            jobfile = Path(tmp) / "cli.hcl"
            jobfile.write_text(AGENT_CLI_JOB % ("agent-cli", dcs,
                                                c2m.BURST_COUNT))
            cli = []
            for argv in (["job", "run", str(jobfile)],
                         ["job", "status", "agent-cli"]):
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-m", "nomad_tpu_torch", "-address",
                     addr, *argv], capture_output=True, text=True,
                    timeout=120, cwd=str(root))
                cli.append({"argv": argv[:2], "rc": proc.returncode,
                            "s": time.perf_counter() - t0})
                check(proc.returncode == 0,
                      f"{ctx}: {' '.join(argv[:2])} exited "
                      f"{proc.returncode}: {proc.stdout[-1500:]} "
                      f"{proc.stderr[-1500:]}")
            res["cli"] = cli
            placed = api.jobs.allocations("agent-cli")
            check(len(placed) == c2m.BURST_COUNT,
                  f"{ctx}: the CLI's job has {len(placed)} allocs")

            # -- job plan on the card (endpoints.job_plan) ---------------
            plan_job = c2m.burst_job(rng, 0, prefix="agent-plan")
            t0 = time.perf_counter()
            plan = api.jobs.plan(encode(plan_job))
            res["job_plan_s"] = time.perf_counter() - t0
            check(not plan["FailedTGAllocs"],
                  f"{ctx}: job plan failed to place: "
                  f"{plan['FailedTGAllocs']}")
            updates = (plan["Annotations"] or {}).get(
                "DesiredTGUpdates", {})
            places = sum(u.get("Place", 0) for u in updates.values())
            check(places == c2m.BURST_COUNT,
                  f"{ctx}: job plan places {places}: {updates}")
            res["job_plan_places"] = places

            # -- a traced burst: the waterfall of the host work ----------
            api.put("/v1/operator/traces", {"Enable": True, "Reset": True})
            traced = [c2m.burst_job(rng, i, prefix="agent-traced")
                      for i in range(AGENT_TRACED_JOBS)]
            tburst = agent_burst(addr, traced,
                                 time.time() + AGENT_DEADLINE_S,
                                 f"{ctx} traced burst")
            dump = api.get("/v1/operator/traces?limit=0")
            api.put("/v1/operator/traces", {"Enable": False})
            traced_scrape = scrape(addr)
            spans = dump["Spans"]
            wfs = build_waterfalls([span_from_api(r) for r in spans])
            tail = aggregate_tail(wfs)
            res["traced"] = {
                "evals_per_s": tburst["evals_per_s"],
                "spans": len(spans), "waterfalls": len(wfs),
                "tail": {k: v for k, v in tail.items() if k != "slowest"},
                "span_exclusive": span_table(spans),
                "b1_launches": int(traced_scrape[
                    "nomad_tpu_wave_fused_launches_total"]),
            }
            check(traced_scrape["nomad_tpu_wave_fused_fallbacks_total"] == 0
                  and traced_scrape["nomad_tpu_wave_fused_failures_total"]
                  == 0 and traced_scrape[
                      "nomad_tpu_device_state_errors_total"] == 0,
                  f"{ctx}: the traced burst fell back, failed or erred")
            check(len(wfs) >= AGENT_TRACED_JOBS,
                  f"{ctx}: {len(wfs)} waterfalls of {AGENT_TRACED_JOBS}")

            # -- the agent's store, read back through its snapshot, and
            # checked while the agent stops --------------------------------
            t0 = time.perf_counter()
            _meta, data = read_snapshot(api.operator.snapshot_save())
            res["snapshot_save_s"] = time.perf_counter() - t0
            nodes = api.nodes.list()
            down = sum(1 for n in nodes if n["Status"] != "ready")
            check(down == 0, f"{ctx}: {down} restored nodes not ready")
            res["child_rss_gb"] = child.rss_gb()
            child.terminate()
            t0 = time.perf_counter()
            final = StateStore()
            final.restore_from_bytes(data)
            del data
            all_jobs = [(j.namespace, j.id, c2m.BURST_COUNT)
                        for j in warm + jobs + traced]
            all_jobs.append(("default", "agent-cli", c2m.BURST_COUNT))
            res["store"] = check_agent_store(
                final, all_jobs, res["warmup"]["eval_ids"]
                + burst["eval_ids"] + tburst["eval_ids"], dev, ctx)
            res["store"]["check_s"] = time.perf_counter() - t0
            del final
            res["warmup"].pop("eval_ids")
            res["warmup"].pop("registered_at")
            res["stop"] = child.wait_exit(AGENT_STOP_S)
            check(res["stop"]["rc"] == 0,
                  f"{ctx}: SIGTERM gave {res['stop']}: {child.stderr()}")
        except BaseException:
            # the failure propagates; the agent's own account goes first
            log(f"{ctx}: failed; the agent exited {child.proc.poll()}, its "
                f"stderr ends: {child.stderr()}")
            raise
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
            child.kill()
    res["phase_s"] = time.perf_counter() - t_phase
    res["window_off_server"] = {k: window_off.get(k) for k in (
        "evals_per_s", "e2e_p50_ms", "e2e_p99_ms", "plan_p50_ms",
        "plan_p99_ms", "b1_launches", "waves", "wave_fill", "restore_s")}
    log(f"agent: {json.dumps(res)}")
    record["agent"] = res
    return res



# ---------------------------------------------------------------------------
# Phase 16: the client on the card: ``agent -dev`` runs what B1 places.
# ---------------------------------------------------------------------------

CLIENT_CLASS = "card-client"    # the dev client's node class
CLIENT_JOBS = 32                # the burst's batch jobs
CLIENT_COUNT = 4                # allocations of each
CLIENT_DISK_MB = 10             # each group's ephemeral disk
CLIENT_SERVICE_COUNT = 2
CLIENT_REGISTER_S = 60.0        # the dev node back after the restore
CLIENT_RUN_S = 120.0            # every alloc of the burst complete
CLIENT_SERVICE_S = 60.0         # the service running, then stopped
CLIENT_POLL_S = 0.1
#: phase 15's server block; ``-dev`` enables the client, and the client
#: block names its node's class, the one the jobs are pinned to
CLIENT_CONFIG = AGENT_CONFIG + """
client {
  node_class = "%s"
}
"""
#: the Prometheus series whose deltas gate the burst
CLIENT_SERIES = (
    "nomad_tpu_wave_fused_launches_total",
    "nomad_tpu_wave_fused_fallbacks_total",
    "nomad_tpu_wave_fused_failures_total",
    "nomad_tpu_device_state_errors_total",
    'nomad_tpu_wave_launches_total{fired="full"}',
    'nomad_tpu_wave_launches_total{fired="deadline"}')


def pinned_job(job_id: str, job_type: str, command: str, args: list,
               count: int, devices: list = (), spreads: list = ()):
    """A lean job (cpu and memory only, phase 13's node-agent ask) whose
    one raw_exec task runs ``command args``, pinned by its constraint to
    the nodes of ``CLIENT_CLASS``, its group spread as ``spreads`` say."""
    from nomad_tpu_torch import structs

    job = mock.simple_job(id=job_id, type=job_type, datacenters=["dc1"])
    job.constraints = [structs.Constraint(
        ltarget="${node.class}", rtarget=CLIENT_CLASS, operand="=")]
    tg = job.task_groups[0]
    tg.count = count
    tg.spreads = list(spreads)
    tg.ephemeral_disk = structs.EphemeralDisk(size_mb=CLIENT_DISK_MB)
    task = tg.tasks[0]
    task.driver = "raw_exec"
    task.config = {"command": command, "args": list(args)}
    task.resources = structs.Resources(cpu=AGENT_CPU, memory_mb=AGENT_MEM,
                                       devices=list(devices))
    return job


def leftover_processes(pattern: str) -> list:
    """``pgrep -f pattern``: the pids whose command line matches."""
    out = subprocess.run(["pgrep", "-f", pattern], capture_output=True,
                         text=True)
    check(out.returncode in (0, 1),
          f"pgrep -f {pattern!r} exited {out.returncode}: {out.stderr}")
    return [int(p) for p in out.stdout.split()
            if int(p) != os.getpid()]


def processes_end(pattern: str, what: str, timeout: float = 10.0) -> None:
    """Fail unless no process matches ``pattern`` within ``timeout``: an
    executor and its log collectors end just after their task reports."""
    deadline = time.time() + timeout
    while (left := leftover_processes(pattern)):
        check(time.time() < deadline, f"{what}: {len(left)} processes "
              f"left after {timeout} s: {left}")
        time.sleep(CLIENT_POLL_S)


def task_events(alloc: dict, task: str) -> tuple:
    """The task's state, ``failed``, restarts, events (type, ns) and exit
    codes (from its ``Terminated`` events) in an alloc's wire form."""
    ts = (alloc.get("TaskStates") or {}).get(task) or {}
    events = [(e["Type"], e["TimeNs"]) for e in ts.get("Events") or ()]
    exits = [int(e["Message"].split("exit code ", 1)[1].split(",")[0])
             for e in ts.get("Events") or ()
             if e["Type"] == "Terminated" and "exit code " in e["Message"]]
    return (ts.get("State"), ts.get("Failed"), ts.get("Restarts"), events,
            exits)


def committed(allocs: list) -> dict:
    """The cpu and memory the server has committed on a node: the sum of
    the ``AllocatedResources`` of its allocs (wire form) that are not
    terminal."""
    used = {"cpu": 0, "memory_mb": 0}
    for a in allocs:
        if a["DesiredStatus"] != "run" or a["ClientStatus"] in (
                "complete", "failed", "lost"):
            continue
        for t in a["AllocatedResources"]["Tasks"].values():
            used["cpu"] += t["CPU"]["CPUShares"]
            used["memory_mb"] += t["Memory"]["MemoryMB"]
    return used


def stage_ms(deltas: list) -> dict:
    """p50 and p99 of ``deltas`` (seconds) in milliseconds."""
    return {"p50_ms": percentile(deltas, 0.5) * 1e3,
            "p99_ms": percentile(deltas, 0.99) * 1e3}


def wave_widths(kernel_summary: dict) -> list:
    """The node widths (``n_pad``) of the fused waves in the profiler's
    per-key summary (the key is ``b_pad/t_pad/n_pad/...``)."""
    return sorted({int(row["Key"].split("/")[2])
                   for row in kernel_summary["PerKey"]
                   if row["Kernel"] == "fused_wave"})


def run_client_phase(dev: torch.device, record: dict, state_bytes: bytes,
                     card: str, device: str = "") -> dict:
    """Phase 16: part A, ``agent -dev`` in a child process on the card
    (``device`` names another) over phase 11's state; part B, a server
    and a client with the CUDA device plugin in this process."""
    import base64

    from nomad_tpu_torch.api.client import APIClient, APIError
    from nomad_tpu_torch.api.codec import encode
    from nomad_tpu_torch.drivers.rawexec import executor_path
    from nomad_tpu_torch.telemetry.waterfall import (
        aggregate_tail,
        build_waterfalls,
    )
    from nomad_tpu_torch.tensors.schema import pad_bucket

    ctx = "client"
    t_phase = time.perf_counter()
    res: dict = {"card": card, "jobs": CLIENT_JOBS, "count": CLIENT_COUNT}
    root = Path(__file__).resolve().parent
    nonce = f"{os.getpid()}{int(time.time() * 1e3) % 100000}"
    marker = f"card-smoke-{nonce}"
    sleeper = f"600.{nonce}"
    # raw_exec supervises its tasks through the native executor only
    t0 = time.perf_counter()
    exe = executor_path()
    res["executor_s"] = time.perf_counter() - t0
    check(exe is not None, f"{ctx}: the native executor did not build")
    res["executor"] = exe
    ours: set = set()   # the phase's alloc ids, in its tasks' processes
    with tempfile.TemporaryDirectory(prefix="client_") as tmp:
        cfg = Path(tmp) / "agent.hcl"
        cfg.write_text(CLIENT_CONFIG % (SERVER_BATCH, CLIENT_CLASS))
        # the client's data dir (alloc dirs, logs) lies under the
        # child's temp dir, removed with this one
        (Path(tmp) / "tmp").mkdir()
        t0 = time.perf_counter()
        child = AgentChild(str(cfg), str(Path(tmp) / "agent.log"), device,
                           flags=("-dev",),
                           env={"NOMAD_TPU_LOGMON_ORPHAN_EXIT": "1",
                                "TMPDIR": str(Path(tmp) / "tmp")})
        try:
            archive, n_nodes = operator_archive(state_bytes)
            addr = child.wait_ready(AGENT_START_S)
            res["start_s"] = time.perf_counter() - t0
            api = APIClient(addr)
            (own,) = api.nodes.list()
            node_id = own["ID"]
            check(own["NodeClass"] == CLIENT_CLASS,
                  f"{ctx}: the dev node's class is {own['NodeClass']}")

            # -- restore phase 11's state; the dev client re-registers --
            body = base64.b64encode(archive).decode()
            del archive
            t0 = time.perf_counter()
            api.put("/v1/operator/snapshot", {"Snapshot": body})
            res["restore_s"] = time.perf_counter() - t0
            del body
            t0 = time.perf_counter()
            deadline = time.time() + CLIENT_REGISTER_S
            while True:
                nodes = api.nodes.list()
                ready = [n for n in nodes if n["Status"] == "ready"]
                mine = [n for n in nodes if n["NodeClass"] == CLIENT_CLASS]
                if (len(nodes) == n_nodes + 1 == len(ready)
                        and [n["ID"] for n in mine] == [node_id]):
                    break
                check(time.time() < deadline,
                      f"{ctx}: {len(nodes)} nodes, {len(ready)} ready, "
                      f"{len(mine)} of class {CLIENT_CLASS} after "
                      f"{CLIENT_REGISTER_S} s")
                time.sleep(CLIENT_POLL_S)
            res["reregister_s"] = time.perf_counter() - t0
            res["nodes"] = len(ready)
            node = api.get(f"/v1/node/{node_id}")
            nres, rres = node["NodeResources"], node["ReservedResources"]
            cap_cpu = nres["CPU"]["CPUShares"] - rres["CPUShares"]
            cap_mem = nres["Memory"]["MemoryMB"] - rres["MemoryMB"]
            res["node_capacity"] = {"cpu": cap_cpu, "memory_mb": cap_mem}

            # -- the burst: 32 batch jobs of 4 echoes, every count at 0 --
            # each echo waits, after its line, for a file named by its
            # alloc id: the phase reads the log while the task runs, since
            # the client keeps 50 terminal allocs and removes the dirs,
            # logs included, of older ones as soon as more complete
            release = Path(tmp) / "release"
            release.mkdir()
            echo = ('echo "$NOMAD_ALLOC_ID"; '
                    f'while [ ! -e "{release}/$NOMAD_ALLOC_ID" ]; '
                    'do sleep 0.05; done')
            jobs = [pinned_job(
                f"client-echo-{i}", consts.JOB_TYPE_BATCH, "/bin/sh",
                ["-c", echo, marker], CLIENT_COUNT)
                for i in range(CLIENT_JOBS)]
            api.put("/v1/operator/traces", {"Enable": True, "Reset": True})
            before = scrape(addr)
            t0 = time.perf_counter()
            burst = agent_burst(addr, jobs, time.time() + AGENT_DEADLINE_S,
                                f"{ctx} burst")
            registered = {job.id: at for job, at in zip(
                jobs, burst["registered_at"])}
            task = jobs[0].task_groups[0].tasks[0].name
            peak = {"cpu": 0, "memory_mb": 0}
            # each alloc's stdout, read once its line is there, then the
            # task released
            logged: dict = {}
            deadline = time.time() + CLIENT_RUN_S
            while True:
                on_node = api.get(f"/v1/node/{node_id}/allocations")
                allocs = [a for a in on_node if a["JobID"] in registered]
                ours.update(a["ID"] for a in allocs)
                used = committed(on_node)
                peak = {k: max(peak[k], used[k]) for k in peak}
                for a in allocs:
                    if (a["ClientStatus"] not in ("running", "complete")
                            or a["ID"] in logged):
                        continue
                    out = api.allocations.logs(a["ID"], task, "stdout")
                    if out.endswith("\n") or a["ClientStatus"] != "running":
                        logged[a["ID"]] = out
                        (release / a["ID"]).touch()
                if (len(allocs) == CLIENT_JOBS * CLIENT_COUNT
                        and len(logged) == len(allocs)
                        and all(a["ClientStatus"] == "complete"
                                for a in allocs)):
                    break
                done = sum(a["ClientStatus"] == "complete" for a in allocs)
                check(time.time() < deadline,
                      f"{ctx}: {done} of {len(allocs)} allocs complete "
                      f"after {CLIENT_RUN_S} s")
                time.sleep(CLIENT_POLL_S)
            res["run_s"] = time.perf_counter() - t0
            after = scrape(addr)
            traces = api.get("/v1/operator/traces?limit=0")
            api.put("/v1/operator/traces", {"Enable": False})
            delta = {k: after.get(k, 0.0) - before.get(k, 0.0)
                     for k in CLIENT_SERIES}
            res["scrape"] = delta
            res["client_launches"] = launches = int(
                delta["nomad_tpu_wave_fused_launches_total"])
            waves = int(delta['nomad_tpu_wave_launches_total{fired="full"}']
                        + delta['nomad_tpu_wave_launches_total'
                                '{fired="deadline"}'])
            res["waves"] = waves
            res["evals_per_wave"] = CLIENT_JOBS / waves if waves else 0.0
            res["wave_fill_ratio"] = after["nomad_tpu_wave_fill_ratio"]
            res["evals_per_s"] = burst["evals_per_s"]
            res["send_s"] = burst["send_s"]
            res["register_p50_ms"] = burst["register_p50_ms"]
            res["register_p99_ms"] = burst["register_p99_ms"]
            # the evals' e2e split into the server's segments, and the
            # waves' launches split into the profiler's stages
            tail = aggregate_tail(build_waterfalls(
                [span_from_api(r) for r in traces["Spans"]]))
            res["eval_tail"] = {k: v for k, v in tail.items()
                                if k != "slowest"}
            res["kernel_profile"] = {
                k: traces["Kernel"][k] for k in ("StageSeconds", "Misses",
                                                 "Launches")}
            check(1 <= launches < CLIENT_JOBS,
                  f"{ctx}: {launches} B1 launches for {CLIENT_JOBS} evals: "
                  f"{delta}")
            check(delta["nomad_tpu_wave_fused_fallbacks_total"] == 0
                  and delta["nomad_tpu_wave_fused_failures_total"] == 0
                  and delta["nomad_tpu_device_state_errors_total"] == 0,
                  f"{ctx}: waves fell back, failed or erred: {delta}")
            widths = wave_widths(traces["Kernel"])
            res["wave_n_pad"] = widths
            check(widths == [pad_bucket(n_nodes + 1)],
                  f"{ctx}: fused waves at widths {widths}, want "
                  f"{pad_bucket(n_nodes + 1)}")
            # what the server committed on the node, read while the
            # burst ran
            check(0 < peak["cpu"] <= cap_cpu
                  and 0 < peak["memory_mb"] <= cap_mem,
                  f"{ctx}: the node's committed resources peaked at {peak}, "
                  f"its capacity {res['node_capacity']}")
            res["peak_committed"] = peak

            # -- every alloc: its node, its task, its exit, its log ------
            stages = {"placed": [], "running": [], "complete": [],
                      "e2e": []}
            for a in allocs:
                state, failed, restarts, events, exits = task_events(
                    a, task)
                check(a["NodeID"] == node_id
                      and (state, failed, restarts, exits)
                      == ("dead", False, 0, [0]),
                      f"{ctx}: alloc {a['Name']} on {a['NodeID']}: "
                      f"{(state, failed, restarts, exits)}")
                started = next(ns for t, ns in events if t == "Started")
                ended = next(ns for t, ns in events if t == "Terminated")
                reg = registered[a["JobID"]] * 1e9
                stages["placed"].append((a["CreateTimeNs"] - reg) / 1e9)
                stages["running"].append((started - a["CreateTimeNs"]) / 1e9)
                # the task's run includes its wait for the release
                stages["complete"].append((ended - started) / 1e9)
                stages["e2e"].append((ended - reg) / 1e9)
                check(logged[a["ID"]] == a["ID"] + "\n",
                      f"{ctx}: alloc {a['ID']} logged {logged[a['ID']]!r}")
            res["alloc_stages"] = {k: stage_ms(v) for k, v in stages.items()}
            # the CLI reads the log of an alloc whose dir the client keeps
            kept = None
            for a in sorted(allocs, key=lambda a: a["CreateIndex"],
                            reverse=True):
                try:
                    api.allocations.logs(a["ID"], task, "stdout")
                except APIError:
                    continue
                kept = a["ID"]
                break
            check(kept is not None, f"{ctx}: the client kept no alloc's log")
            proc = subprocess.run(
                [sys.executable, "-m", "nomad_tpu_torch", "-address", addr,
                 "alloc", "logs", kept, task],
                capture_output=True, text=True, timeout=120, cwd=str(root))
            check(proc.returncode == 0 and proc.stdout == kept + "\n",
                  f"{ctx}: alloc logs exited {proc.returncode}: "
                  f"{proc.stdout[-500:]} {proc.stderr[-1500:]}")
            processes_end(marker, f"{ctx}: the echo tasks")

            # -- a service job: started, then stopped by the CLI --------
            svc = pinned_job(f"client-svc-{nonce}", consts.JOB_TYPE_SERVICE,
                             "/bin/sleep", [sleeper], CLIENT_SERVICE_COUNT)
            t0 = time.perf_counter()
            api.jobs.register(encode(svc))
            deadline = time.time() + CLIENT_SERVICE_S
            while True:
                sallocs = api.jobs.allocations(svc.id)
                ours.update(a["ID"] for a in sallocs)
                if len(sallocs) == CLIENT_SERVICE_COUNT and all(
                        a["ClientStatus"] == "running" for a in sallocs):
                    break
                check(time.time() < deadline,
                      f"{ctx}: service allocs "
                      f"{[a['ClientStatus'] for a in sallocs]}")
                time.sleep(CLIENT_POLL_S)
            res["service_start_s"] = time.perf_counter() - t0
            check(len(leftover_processes(f"^/bin/sleep {sleeper}$"))
                  == CLIENT_SERVICE_COUNT,
                  f"{ctx}: the service's tasks are not both running")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "nomad_tpu_torch", "-address", addr,
                 "job", "stop", svc.id], capture_output=True, text=True,
                timeout=120, cwd=str(root))
            check(proc.returncode == 0,
                  f"{ctx}: job stop exited {proc.returncode}: "
                  f"{proc.stdout[-500:]} {proc.stderr[-1500:]}")
            deadline = time.time() + CLIENT_SERVICE_S
            while True:
                sallocs = api.jobs.allocations(svc.id)
                if all(a["ClientStatus"] == "complete" for a in sallocs):
                    break
                check(time.time() < deadline,
                      f"{ctx}: stopped service allocs "
                      f"{[a['ClientStatus'] for a in sallocs]}")
                time.sleep(CLIENT_POLL_S)
            res["service_stop_s"] = time.perf_counter() - t0
            processes_end(f"sleep {sleeper}",
                          f"{ctx}: the stopped service's tasks")

            res["child_rss_gb"] = child.rss_gb()
            child.terminate()
            res["stop"] = child.wait_exit(AGENT_STOP_S)
            check(res["stop"]["rc"] == 0,
                  f"{ctx}: SIGTERM gave {res['stop']}: {child.stderr()}")
            processes_end("|".join([marker, f"sleep {sleeper}", *ours]),
                          f"{ctx}: after the agent's exit, its tasks and "
                          "log collectors")
        finally:
            child.kill()
    res["device_plugin"] = run_device_part(dev, card, nonce)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"client: {json.dumps(res)}")
    record["client"] = res
    return res


def run_device_part(dev: torch.device, card: str, nonce: str) -> dict:
    """Part B of phase 16: the card as a schedulable device. A server on
    ``dev`` and a client with ``CudaDevicePlugin`` in this process; one
    job holds the card, a second asking for it is blocked until the first
    is stopped, then runs and sees it as ``CUDA_VISIBLE_DEVICES=0``."""
    from nomad_tpu_torch import structs
    from nomad_tpu_torch.client.client import (
        Client,
        ClientConfig,
        InProcessRPC,
    )
    from nomad_tpu_torch.ops.kernel import single_eval_stats
    from nomad_tpu_torch.plugins.device import CudaDevicePlugin
    from nomad_tpu_torch.structs.resources import RequestedDevice

    ctx = "client device"
    t_part = time.perf_counter()
    res: dict = {}
    ask = [RequestedDevice(name="nvidia/gpu", count=1)]
    holder = pinned_job(f"card-holder-{nonce}", consts.JOB_TYPE_BATCH,
                        "/bin/sleep", [f"600.{nonce}"], 1, ask)
    # the reader also spreads over datacenters: a spread stanza rules the
    # candidate set out, so its evals take the full width, the joint kernel
    reader = pinned_job(f"card-reader-{nonce}", consts.JOB_TYPE_BATCH,
                        "/bin/sh", ["-c", 'echo "$CUDA_VISIBLE_DEVICES"',
                                    f"card-smoke-{nonce}"], 1, ask,
                        [structs.Spread(attribute="${node.datacenter}")])
    with tempfile.TemporaryDirectory(prefix="client_device_") as data:
        srv = Server(ServerConfig(device=dev, num_workers=1,
                                  gc_tuning=False))
        srv.start()
        client = None
        try:
            client = Client(InProcessRPC(srv), ClientConfig(
                data_dir=data, node_class=CLIENT_CLASS,
                update_batch_interval=0.05),
                device_plugins=[CudaDevicePlugin()])
            client.start()
            deadline = time.time() + CLIENT_REGISTER_S
            while (node := srv.state.snapshot().node_by_id(
                    client.node_id)) is None or not node.ready():
                check(time.time() < deadline, f"{ctx}: node not ready")
                time.sleep(CLIENT_POLL_S)
            groups = [(g.vendor, g.type, g.name, len(g.instance_ids))
                      for g in node.node_resources.devices]
            res["devices"] = groups
            check(groups == [("nvidia", "gpu", card.split(",")[0].strip(),
                              torch.cuda.device_count())],
                  f"{ctx}: fingerprinted {groups}, card {card}")
            waves0 = coalesce.fused_wave_stats.snapshot()
            single0 = single_eval_stats.snapshot()
            joint0 = ck.joint_launches
            cand0 = ck.candidate_launches

            def job_allocs(job):
                return srv.state.snapshot().allocs_by_job(job.namespace,
                                                          job.id)

            def wait(cond, what):
                deadline = time.time() + CLIENT_SERVICE_S
                while not cond():
                    check(time.time() < deadline, f"{ctx}: {what}")
                    time.sleep(CLIENT_POLL_S)

            srv.job_register(holder)
            wait(lambda: [a.client_status for a in job_allocs(holder)]
                 == [consts.ALLOC_CLIENT_RUNNING], "the holder never ran")
            ev_id = srv.job_register(reader)["eval_id"]
            wait(lambda: srv.state.snapshot().eval_by_id(ev_id).status
                 == consts.EVAL_STATUS_COMPLETE, "the reader's eval")
            ev = srv.state.snapshot().eval_by_id(ev_id)
            metric = ev.failed_tg_allocs.get(reader.task_groups[0].name)
            check(not job_allocs(reader) and metric is not None
                  and ev.blocked_eval,
                  f"{ctx}: the reader was not blocked: "
                  f"{len(job_allocs(reader))} allocs, {metric}")
            res["blocked"] = {"dimension_exhausted":
                              dict(metric.dimension_exhausted),
                              "nodes_exhausted": metric.nodes_exhausted}
            check(metric.nodes_exhausted == 1,
                  f"{ctx}: the reader's metric {metric}")
            t0 = time.perf_counter()
            srv.job_deregister(holder.namespace, holder.id)
            wait(lambda: [a.client_status for a in job_allocs(reader)]
                 == [consts.ALLOC_CLIENT_COMPLETE],
                 "the reader never ran after the holder stopped")
            res["unblock_s"] = time.perf_counter() - t0
            (alloc,) = job_allocs(reader)
            logs = os.path.join(data, "allocs", alloc.id, "alloc", "logs",
                                f"{reader.task_groups[0].tasks[0].name}"
                                ".stdout.0")
            seen = Path(logs).read_text()
            res["cuda_visible_devices"] = seen.strip()
            check(seen == "0\n", f"{ctx}: the task saw {seen!r}")
            wait(lambda: all(a.client_terminal_status()
                             for a in job_allocs(holder)),
                 "the holder never stopped")
            waves1 = coalesce.fused_wave_stats.snapshot()
            single1 = single_eval_stats.snapshot()
            route = {"fused_wave_" + k: waves1[k] - waves0[k]
                     for k in waves1}
            route.update({"single_" + k: single1[k] - single0[k]
                          for k in single1})
            route["joint_launches"] = ck.joint_launches - joint0
            route["candidate_launches"] = ck.candidate_launches - cand0
            res["route"] = route
            # one eval at a time: the holder's through the candidate set,
            # one call of its kernel, the reader's (blocked, then
            # released) through the full width, one joint launch each
            on_card = dev.type == "cuda"
            check(route["fused_wave_launches"] == 0
                  and route["fused_wave_fallbacks"] == 0
                  and route["fused_wave_failures"] == 0
                  and route["single_topk"] >= 1
                  and route["single_full"] >= 2
                  and route["candidate_launches"] == (
                      route["single_topk"] if on_card else 0)
                  and route["joint_launches"] == (
                      route["single_full"] if on_card else 0),
                  f"{ctx}: the device asks' route {route}")
            log(f"{ctx}: route {route}")
        finally:
            if client is not None:
                client.shutdown()
            srv.shutdown()
    processes_end(f"card-smoke-{nonce}|sleep 600.{nonce}",
                  f"{ctx}: the tasks")
    res["part_s"] = time.perf_counter() - t_part
    return res


def client_phase_alone(argv: list) -> int:
    """``chip_smoke.py --client-phase [--device cpu] [--nodes N] [--allocs
    M]``: phase 16 alone, on the state of ``c2m.generate(N, M)`` (the C2M
    replay's 10,000 nodes and 100k allocs unless given). On the card the
    kernels are built first. ``--device cpu`` rehearses it on the CPU:
    the agent child runs with ``-device cpu``, and part B's client sees
    one stand-in card through a patched ``torch.cuda``."""
    import argparse
    from unittest import mock as patch

    ap = argparse.ArgumentParser(prog="chip_smoke.py --client-phase")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nodes", type=int, default=c2m.N_NODES)
    ap.add_argument("--allocs", type=int, default=c2m.N_ALLOCS)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("chip_smoke: --client-phase needs an NVIDIA card; "
                  "--device cpu rehearses it", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        log(f"card: {card}")
        ck.load_libraries()
    t0 = time.perf_counter()
    state_bytes = c2m.generate(args.nodes, args.allocs).to_snapshot_bytes()
    log(f"client phase: state of {args.nodes} nodes in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.device == "cuda":
        run_client_phase(torch.device("cuda"), {}, state_bytes, card)
        return 0
    card = "stand-in card, 0 W"
    with patch.patch.object(torch.cuda, "is_available",
                            return_value=True), \
            patch.patch.object(torch.cuda, "device_count", return_value=1), \
            patch.patch.object(torch.cuda, "get_device_name",
                               return_value="stand-in card"):
        run_client_phase(torch.device("cpu"), {}, state_bytes, card,
                         device="cpu")
    return 0



# ---------------------------------------------------------------------------
# Phase 17: the node-axis mesh.
# ---------------------------------------------------------------------------

MESH_SHARDS = (2, 4, 8)         # part A: virtual meshes over the one card
MESH_SPREAD_SHARDS = 4          # part A: the spread wave's joint sharded run
MESH_SCALE_SHARDS = 8           # part A: the wave at N=131072
MESH_STATE_SHARDS = 4           # part B: the resident state's mesh
MESH_SERVER_SHARDS = 4          # part C: the server's mesh
MESH_LIVE_NODES = 10_000        # part A's cluster, phase 3's
MESH_LIVE_ALLOCS = 100_000
MESH_SCALE_NODES = 100_000      # part A's scale wave, phase 5's
MESH_SCALE_ALLOCS = 1_000_000
MESH_CHURN = 320                # part B: allocs stopped between the waves
MESH_WARM_REPEATS = 3           # part A: warm repeats of the first wave
MESH_KERNEL_SHARDS = 4          # part A: the kernel against its plain version
MESH_WIDE_SHARDS = 4            # part A: phase 4's N=524288 on the one card
MESH_WIDE_NODES = CEILING_NODES
MESH_WIDE_ALLOCS = CEILING_ALLOCS
MESH_CARDS_WIDE_NODES = 600_000  # --mesh-phase: N=1048576 over the cards
MESH_CARDS_WIDE_ALLOCS = 2_000_000
MESH_TIMED_VARIANT = "kitchen_sink"  # part A: the kernel's and plain's times
MESH_SPREAD_JOBS = 64           # part C: the spread arm's burst


def spread_burst_job(rng, i: int, prefix: str = "mesh-spread"):
    """A burst job (``c2m.burst_job``) whose group spreads over the
    datacenters: its waves leave the fused envelope."""
    from nomad_tpu_torch import structs

    job = c2m.burst_job(rng, i, prefix=prefix)
    job.task_groups[0].spreads = [structs.Spread(
        attribute="${node.datacenter}", weight=50)]
    return job


def traced_burst(srv, jobs, ctx: str) -> dict:
    """One server burst under the tracer: its host seconds, and each
    span's count, total and exclusive ms (``tracer.stage_totals``): the
    scheduler's stages (``eval.schedule``, ``sched.*``), the wave's
    (``wave.park``, ``wave.assemble``, ``wave.launch``, ``kernel.d2h``)
    and the plan's (``plan.*``), on every thread."""
    from nomad_tpu_torch.telemetry.trace import tracer

    tracer.enable()
    tracer.reset()
    try:
        t0 = time.perf_counter()
        for job in jobs:
            srv.job_register(job)
        burst_s = server_converged(srv, jobs,
                                   time.time() + SERVER_DEADLINE_S) - t0
        totals = tracer.stage_totals()
    finally:
        tracer.disable()
        tracer.reset()
    check_server_burst(srv, jobs, ctx)
    top = sorted(totals.items(), key=lambda kv: -kv[1]["exclusive_s"])[:8]
    log(f"{ctx}: {len(jobs)} jobs in {burst_s:.3f} s; exclusive ms by "
        "span: " + ", ".join(f"{name} {v['exclusive_s'] * 1e3:.1f} "
                             f"({v['count']})" for name, v in top))
    return {"jobs": len(jobs), "burst_s": burst_s,
            "spans": {name: {"count": v["count"],
                             "total_ms": v["total_s"] * 1e3,
                             "exclusive_ms": v["exclusive_s"] * 1e3}
                      for name, v in totals.items()}}


def event_ms(fn):
    """``(fn(), ms)``: the call's time between two CUDA events on the
    current stream, the call's own synchronisations included."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def wave_host(outs) -> dict:
    """A launch_wave's member slices as flat host arrays, member after
    member: steps, top-k rows, and the i32 metrics [B, 8]."""
    cat = np.concatenate
    return {
        "chosen": cat([np.asarray(o.chosen) for o in outs]),
        "found": cat([np.asarray(o.found) for o in outs]),
        "scores": cat([np.asarray(o.scores) for o in outs]),
        "topk_idx": cat([np.asarray(o.topk_idx) for o in outs]),
        "topk_scores": cat([np.asarray(o.topk_scores) for o in outs]),
        "metrics": np.array([[int(getattr(o, f)) for f in FUSED_METRIC_FIELDS]
                             for o in outs]),
    }


def compare_waves(got, want, ctx: str, exact: bool = False) -> dict:
    """Two launch_wave results on the same inputs, as ``compare`` holds
    kernel against plain: metrics, choices, found and top-k indices
    exact, scores and top-k scores within ATOL (``exact``: 0.0); the
    first differing step is excused only as a near-tie (counted) and the
    steps after it are not compared."""
    g, w = wave_host(got), wave_host(want)
    check(np.array_equal(g["metrics"], w["metrics"]),
          f"{ctx}: i32 metrics differ")
    differs = (g["chosen"] != w["chosen"]) | (g["found"] != w["found"]) \
        | np.any(g["topk_idx"] != w["topk_idx"], axis=1)
    bad = np.nonzero(differs)[0]
    near_ties, upto = 0, len(differs)
    if len(bad):
        s = int(bad[0])
        row = w["topk_scores"][s]
        gaps = [abs(float(row[i]) - float(row[i + 1]))
                for i in range(len(row) - 1)]
        check(min(gaps) < NEAR_TIE,
              f"{ctx}: step {s} differs and is no near-tie (reference "
              f"top-k {row.tolist()})")
        near_ties, upto = 1, s
    err = float(max(
        np.abs(g["scores"][:upto] - w["scores"][:upto]).max(initial=0.0),
        np.abs(g["topk_scores"][:upto]
               - w["topk_scores"][:upto]).max(initial=0.0)))
    check(err <= (0.0 if exact else ATOL),
          f"{ctx}: max abs error {err} > {0.0 if exact else ATOL}")
    return {"ctx": ctx, "near_ties": near_ties, "max_abs_err": err,
            "placed": int(g["found"].sum())}


def mesh_bound(kins, features, dev: torch.device) -> tuple:
    """``(bound_ms, bound_by)`` of a wave split over virtual shards on one
    card: the unsharded wave's bytes and operations (the shards do the
    same work), from its assembly on ``dev``."""
    wave = coalesce.assemble_wave(kins, [K_STEPS] * len(kins), features, dev)
    t, b = wave.t_pad, wave.b_pad
    n = int(wave.kin.cap_cpu.shape[-1])
    # its outputs: the packed buffer, the top-k planes, the three carries
    out_bytes = 4 * (2 * t + 8 * b) + 2 * 4 * t * 8 + 3 * 4 * n
    return bound(wave_bytes(wave, []) + out_bytes, wave_ops(wave))


def cluster_launches() -> int:
    """The sharded kernel's launches so far, every card's, as the C side
    counts them (one a card a wave)."""
    return ck.sharded_kernel_launches()


def joint_cluster_launches() -> int:
    """The joint sharded kernel's launches so far, every card's, as the C
    side counts them (one a card a wave)."""
    return ck.joint_sharded_kernel_launches()


def mesh_wave(kins, features, dev: torch.device, mesh) -> tuple:
    """One launch_wave (over ``mesh``, or B1 on ``dev`` when None): its
    outputs, CUDA-event ms, and the B1 launches, the sharded kernel's
    calls and its kernel launches, and the sharded launches and fallbacks
    it made."""
    l0, k0, c0 = ck.launches, ck.sharded_launches, cluster_launches()
    s0 = coalesce.sharded_wave_stats.snapshot()
    outs, ms = event_ms(lambda: coalesce.launch_wave(
        kins, [K_STEPS] * len(kins), features, device=dev, mesh=mesh))
    s1 = coalesce.sharded_wave_stats.snapshot()
    return outs, ms, {"b1": ck.launches - l0,
                      "kernel": ck.sharded_launches - k0,
                      "clusters": cluster_launches() - c0,
                      "sharded": s1["launches"] - s0["launches"],
                      "fallbacks": s1["fallbacks"] - s0["fallbacks"]}


#: the launches of one wave through the sharded kernel on one card (one C
#: call, one cluster launch), and of one B1 wave
KERNEL_WAVE = {"b1": 0, "kernel": 1, "clusters": 1, "sharded": 1,
               "fallbacks": 0}
B1_WAVE = {"b1": 1, "kernel": 0, "clusters": 0, "sharded": 0,
           "fallbacks": 0}


def whole(out):
    """A sharded FusedWaveOut with its carries gathered on its first
    shard's device."""
    root = out.packed.device
    return out._replace(**{name: torch.cat([p.to(root)
                                            for p in getattr(out, name)])
                           for name in ("a_cpu", "a_mem", "a_disk")})


def kernel_shards(kins, features, dev: torch.device, shards: int,
                  devices=None) -> tuple:
    """A wave assembled over D virtual shards on ``dev`` (or over
    ``devices``), as the sharded kernel's arguments."""
    mesh = sharded.wave_mesh(devices=devices or [dev] * shards)
    wave = coalesce.assemble_sharded_wave(kins, [K_STEPS] * len(kins),
                                          features, mesh)
    return (sharded._shards_of(wave.kin, mesh.node_rows()[0]),
            wave.step_member, wave.step_local, wave.t_pad, wave.features)


def mesh_kernel_ms(kins, features, dev: torch.device, shards: int) -> float:
    """The sharded kernel's CUDA-event ms a wave over D virtual shards
    (ten calls after one)."""
    args = kernel_shards(kins, features, dev, shards)
    ck.sharded_wave_place(*args)
    return cuda_ms(lambda: ck.sharded_wave_place(*args), 10)


def lean_joint_check(kins, features, dev: torch.device, shards: int,
                     ctx: str) -> dict:
    """The joint sharded kernel on a wave the sharded kernel takes (a
    fused-envelope union, TOPK rows a shard or more) over the same D
    virtual shards: held against the sharded kernel's output, exact, and
    both kernels' CUDA-event ms (ten calls after one each): what routing
    every mesh wave to the joint sharded kernel would cost."""
    args = kernel_shards(kins, features, dev, shards)
    want = ck.sharded_wave_place(*args)
    got = ck.joint_sharded_wave_place(*args)
    ck.raise_on_wave_error(got.packed.cpu().numpy(), args[3],
                           int(args[0][0].n_steps.shape[0]))
    flat = coalesce.assemble_wave(kins, [K_STEPS] * len(kins), features,
                                  dev)
    res = compare(whole(got), whole(want), flat, ctx)
    check(res["max_abs_err"] == 0.0 and res["near_ties"] == 0,
          f"{ctx}: the joint sharded kernel differs from the sharded "
          f"kernel: {res}")
    return {"shards": shards, "max_abs_err": res["max_abs_err"],
            "joint_ms": cuda_ms(lambda: ck.joint_sharded_wave_place(*args),
                                10),
            "sharded_ms": cuda_ms(lambda: ck.sharded_wave_place(*args), 10)}


def b1_kernel_ms(kins, features, dev: torch.device) -> float:
    """B1's CUDA-event ms on the same wave, unsharded (ten calls after
    one): the sharded kernel's yardstick in the same call."""
    wave = coalesce.assemble_wave(kins, [K_STEPS] * len(kins), features,
                                  dev)
    args = (wave.kin, wave.step_member, wave.step_local, wave.t_pad,
            wave.features)
    ck.fused_wave_place(*args)
    return cuda_ms(lambda: ck.fused_wave_place(*args), 10)


def sharded_active_steps(args) -> int:
    """The active steps of a sharded wave's arguments (the reference's
    rule, as the wrapper hands them to the kernel)."""
    shards, sm, sl, t_pad = args[:4]
    return len(ck.wave_active_steps(sm, sl, shards[0].n_steps, t_pad,
                                    int(shards[0].step_preferred.shape[-1])))


def mesh_kernel_check(kins, features, dev: torch.device, shards: int,
                      ctx: str, time_it: bool = False) -> dict:
    """The sharded kernel (``ck.sharded_wave_place``) against its plain
    version on the same D virtual shards of one wave: ``compare`` held to
    a max abs error of 0.0, one kernel call. With ``time_it``, also the
    kernel's CUDA-event ms (ten calls) and the plain version's (one)."""
    args = kernel_shards(kins, features, dev, shards)
    k0, l0, c0 = ck.sharded_launches, ck.launches, cluster_launches()
    got = ck.sharded_wave_place(*args)
    clusters = cluster_launches() - c0
    check(ck.sharded_launches == k0 + 1 and ck.launches == l0
          and clusters == 1,
          f"{ctx}: kernel calls {ck.sharded_launches - k0}, cluster "
          f"launches {clusters}, B1 {ck.launches - l0}")
    ck.raise_on_wave_error(got.packed.cpu().numpy(), args[3],
                           int(args[0][0].n_steps.shape[0]))
    want, plain_ms = event_ms(
        lambda: ck.sharded_wave_place_reference(*args))
    flat = coalesce.assemble_wave(kins, [K_STEPS] * len(kins), features,
                                  dev)
    res = compare(whole(got), whole(want), flat, ctx)
    check(res["max_abs_err"] == 0.0,
          f"{ctx}: max abs error {res['max_abs_err']}, want 0.0")
    res["cluster_launches"] = clusters
    if time_it:
        res["ms"] = cuda_ms(lambda: ck.sharded_wave_place(*args), 10)
        res["b1_ms"] = b1_kernel_ms(kins, features, dev)
        res["plain_ms"] = plain_ms
        res["active_steps"] = sharded_active_steps(args)
        res["us_per_active_step"] = res["ms"] * 1e3 / res["active_steps"]
        res["b1_us_per_active_step"] = (res["b1_ms"] * 1e3
                                        / res["active_steps"])
    return res


def joint_mesh_check(kins, features, dev: torch.device, shards: int,
                     ctx: str, devices=None, plain: bool = True) -> dict:
    """A wave the sharded kernel does not take (outside the fused
    envelope, or past its cluster's shared memory) over D virtual shards
    of ``dev`` (or over ``devices``): through ``launch_wave`` (one call of
    the joint sharded kernel, one kernel launch a card of the clusters
    its plan picks, no other kernel, no torch-op wave) against the
    one-device wave (the joint kernel), exact;
    then the kernel alone (``ck.joint_sharded_wave_place``) against its
    plain version and against the one-device joint kernel on the same
    inputs, exact, and its CUDA-event ms (ten calls) beside the joint
    kernel's, the plain version's (one call) and the bound (the one-device
    wave's bytes and operations, ``joint_bound``). Without ``plain`` the
    kernel is held against the one-device joint kernel alone (itself held
    against its plain version at that width in phase 5)."""
    devices = devices or [dev] * shards
    mesh = sharded.wave_mesh(devices=devices)
    cards = len(set(devices))
    j0 = coalesce.joint_wave_stats.snapshot()
    calls, clusters = ck.joint_sharded_launches, joint_cluster_launches()
    want, one_ms, n0 = mesh_wave(kins, features, dev, None)
    got, ms, n1 = mesh_wave(kins, features, dev, mesh)
    j1 = coalesce.joint_wave_stats.snapshot()
    launched = (ck.joint_sharded_launches - calls,
                joint_cluster_launches() - clusters)
    check(n0["b1"] == n1["b1"] == n1["kernel"] == 0 and n1["sharded"] == 1
          and launched == (1, cards)
          and j1["sharded_launches"] - j0["sharded_launches"] == 1
          and j1["torch_waves"] == j0["torch_waves"],
          f"{ctx}: launches {n0} {n1}, joint sharded calls and cluster "
          f"launches {launched}, joint stats {j0} -> {j1}")
    res = compare_waves(got, want, ctx, exact=True)
    check(res["near_ties"] == 0 and res["placed"] > 0, f"{ctx}: {res}")
    res.update(launch_wave_ms=ms, one_device_launch_wave_ms=one_ms)
    args = kernel_shards(kins, features, dev, shards, devices)
    out = ck.joint_sharded_wave_place(*args)
    ck.raise_on_wave_error(out.packed.cpu().numpy(), args[3],
                           int(args[0][0].n_steps.shape[0]))
    others, plain_ms = [], None
    if plain:
        want, plain_ms = event_ms(
            lambda: ck.joint_sharded_wave_place_reference(*args))
        others.append((whole(want), "its plain version"))
    flat = coalesce.assemble_wave(kins, [K_STEPS] * len(kins), features,
                                  dev)
    fargs = (flat.kin, flat.step_member, flat.step_local, flat.t_pad,
             flat.features)
    one = ck.joint_wave_place(*fargs)
    torch.cuda.synchronize()
    for other, name in others + [(one, "the joint kernel")]:
        r = compare(whole(out), other, flat, f"{ctx} vs {name}")
        check(r["max_abs_err"] == 0.0 and r["near_ties"] == 0,
              f"{ctx}: the joint sharded kernel differs from {name}: {r}")
    res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])
    res["kernel_ms"] = cuda_ms(lambda: ck.joint_sharded_wave_place(*args),
                               10)
    res["joint_ms"] = cuda_ms(lambda: ck.joint_wave_place(*fargs), 10)
    res["plain_ms"] = plain_ms
    res["bound_ms"], res["bound_by"], res["bytes"], res["ops"] = \
        joint_bound(flat, one)
    res["active_steps"] = sharded_active_steps(args)
    res["us_per_active_step"] = (res["kernel_ms"] * 1e3
                                 / res["active_steps"])
    # the plan every card ran: its clusters, and where its rows lived
    # (CPU shards: the plain version, no plan)
    plan = (ck.joint_sharded_plan_of(args[0], args[4])
            if dev.type == "cuda" else None)
    res.update(shards=shards, cards=cards,
               n_pad=int(flat.kin.cap_cpu.shape[-1]),
               cluster_launches=launched[1],
               clusters_per_card=plan.clusters if plan else None,
               rows_shared=plan is None or plan.global_rows == 0)
    return res


def mesh_part_a(dev: torch.device, rng) -> dict:
    """Part A: each fused-envelope variant through the sharded wave at
    D = 2, 4 and 8 virtual shards on the card, against B1 (the unsharded
    launch_wave) on the same inputs; one spread wave through the joint
    sharded wave against the composite; one wave at N=131072 at D=8; the
    mesh of the real cards."""
    cluster = c2m_cluster(MESH_LIVE_NODES, seed=SEED)
    ucpu, umem, udisk, _ = c2m_pack_usage(cluster, MESH_LIVE_ALLOCS,
                                          seed=SEED)
    base = base_kin(cluster, (ucpu, umem, udisk))
    rows = {d: {"shards": d, "waves": 0, "sharded_launches": 0,
                "ms": [], "b1_ms": [], "max_abs_err": 0.0, "near_ties": 0}
            for d in MESH_SHARDS}
    parity, bounds = [], []

    # the process's first sharded waves: an inert one (the members with
    # no active step: what a warm launch of the bucket's dummy wave
    # runs), then the first live one (cold), then the same wave repeated
    # (warm); the live result held against B1 on the same inputs
    crng = np.random.default_rng(SEED + 170)
    members = [make_member(base, cluster, "lean", crng)
               for _ in range(B_WAVE)]
    kins, feats = [m[0] for m in members], [m[1] for m in members]
    mesh = sharded.wave_mesh(devices=[dev] * MESH_SERVER_SHARDS)
    inert = [k._replace(n_steps=np.zeros_like(k.n_steps)) for k in kins]
    _, inert_ms, n = mesh_wave(inert, feats, dev, mesh)
    check(n == KERNEL_WAVE, f"mesh/inert: launches {n}")
    got, cold_ms, n = mesh_wave(kins, feats, dev, mesh)
    warm_ms = []
    for _ in range(MESH_WARM_REPEATS):
        _, ms, n1 = mesh_wave(kins, feats, dev, mesh)
        check(n1 == n, f"mesh/cold: launches {n1} after {n}")
        warm_ms.append(ms)
    check(n == KERNEL_WAVE, f"mesh/cold: launches {n}")
    want, cold_b1_ms, n0 = mesh_wave(kins, feats, dev, None)
    b1 = n0["b1"]
    cold = compare_waves(got, want, f"mesh/cold/D={MESH_SERVER_SHARDS}",
                         exact=True)
    cold.update(shards=MESH_SERVER_SHARDS, inert_ms=inert_ms,
                first_ms=cold_ms,
                warm_ms=warm_ms, warm_ms_median=float(np.median(warm_ms)),
                b1_ms=cold_b1_ms)
    parity.append(cold)
    log(f"mesh cold: {json.dumps(cold)}")
    kernel = []          # the kernel against its plain version, D=4
    for variant in VARIANTS:
        members = [make_member(base, cluster, variant, rng)
                   for _ in range(B_WAVE)]
        kins, feats = [m[0] for m in members], [m[1] for m in members]
        want, b1_ms, n = mesh_wave(kins, feats, dev, None)
        check(n == B1_WAVE,
              f"mesh/{variant}: the reference wave's launches {n}")
        b1 += 1
        bounds.append(mesh_bound(kins, feats, dev))
        res = mesh_kernel_check(
            kins, feats, dev, MESH_KERNEL_SHARDS,
            f"mesh kernel/{variant}/D={MESH_KERNEL_SHARDS}",
            time_it=variant == MESH_TIMED_VARIANT)
        res["variant"] = variant
        res["lean_joint"] = [lean_joint_check(
            kins, feats, dev, d, f"mesh lean joint/{variant}/D={d}")
            for d in MESH_SHARDS]
        if variant == MESH_TIMED_VARIANT:
            # the kernel alone at every D (the D=4 time above is the
            # JSON line's), each beside B1's kernel on the same wave
            res["ms_per_d"], res["b1_ms_per_d"] = {}, {}
            for d in MESH_SHARDS:
                res["b1_ms_per_d"][d] = b1_kernel_ms(kins, feats, dev)
                res["ms_per_d"][d] = mesh_kernel_ms(kins, feats, dev, d)
        kernel.append(res)
        for d in MESH_SHARDS:
            mesh = sharded.wave_mesh(devices=[dev] * d)
            got, ms, n = mesh_wave(kins, feats, dev, mesh)
            ctx = f"mesh/{variant}/D={d}"
            check(n == KERNEL_WAVE, f"{ctx}: launches {n}")
            res = compare_waves(got, want, ctx, exact=True)
            check(res["placed"] > 0, f"{ctx}: nothing placed")
            row = rows[d]
            row["waves"] += 1
            row["sharded_launches"] += n["sharded"]
            row["ms"].append(ms)
            row["b1_ms"].append(b1_ms)
            row["max_abs_err"] = max(row["max_abs_err"], res["max_abs_err"])
            row["near_ties"] += res["near_ties"]
            parity.append(res)
        log(f"mesh {variant}: B1 {b1_ms:.2f} ms, sharded "
            f"{[round(rows[d]['ms'][-1], 1) for d in MESH_SHARDS]} ms "
            f"at D={list(MESH_SHARDS)}")
    bound_ms, bound_by = max(bounds)
    for row in rows.values():
        row["ms_median"] = float(np.median(row["ms"]))
        row["b1_ms_median"] = float(np.median(row["b1_ms"]))
        row["bound_ms"], row["bound_by"] = bound_ms, bound_by

    # the joint sharded kernel: each union outside the fused envelope
    # (phase 4's waves) at D=4, against the one-device wave (the joint
    # kernel) and its plain version
    f0 = coalesce.fused_wave_stats.snapshot()
    joint = []
    for union in JOINT_UNIONS:
        kins, feats, _, _ = joint_wave(base, cluster, union, rng, dev)
        res = joint_mesh_check(kins, feats, dev, MESH_SPREAD_SHARDS,
                               f"mesh joint/{union}/D={MESH_SPREAD_SHARDS}")
        res["union"] = union
        joint.append(res)
        log(f"mesh joint {union}: {json.dumps(res)}")
    f1 = coalesce.fused_wave_stats.snapshot()
    check(f1["fallbacks"] - f0["fallbacks"] == 2 * len(JOINT_UNIONS)
          and f1["failures"] == f0["failures"],
          f"mesh/joint: fused stats {f0} -> {f1}")

    # the reference's mesh-cell scale: N=131072 at D=8
    big = c2m_cluster(MESH_SCALE_NODES, seed=SEED + 1)
    bc, bm, bd, _ = c2m_pack_usage(big, MESH_SCALE_ALLOCS, seed=SEED + 1)
    bbase = base_kin(big, (bc, bm, bd))
    members = [make_member(bbase, big, "kitchen_sink", rng)
               for _ in range(B_WAVE)]
    kins, feats = [m[0] for m in members], [m[1] for m in members]
    want, scale_b1_ms, n0 = mesh_wave(kins, feats, dev, None)
    got, scale_ms, n1 = mesh_wave(
        kins, feats, dev,
        sharded.wave_mesh(devices=[dev] * MESH_SCALE_SHARDS))
    check(n0 == B1_WAVE and n1 == KERNEL_WAVE,
          f"mesh/scale: launches {n0} {n1}")
    b1 += 1
    scale = compare_waves(got, want, f"mesh/scale/D={MESH_SCALE_SHARDS}",
                          exact=True)
    scale.update(n_pad=big.n_pad, shards=MESH_SCALE_SHARDS, ms=scale_ms,
                 b1_ms=scale_b1_ms)
    scale["bound_ms"], scale["bound_by"] = mesh_bound(kins, feats, dev)
    scale["b1_kernel_ms"] = b1_kernel_ms(kins, feats, dev)
    scale["kernel_ms"] = mesh_kernel_ms(kins, feats, dev, MESH_SCALE_SHARDS)
    scale["active_steps"] = sharded_active_steps(
        kernel_shards(kins, feats, dev, MESH_SCALE_SHARDS))
    scale["us_per_active_step"] = (scale["kernel_ms"] * 1e3
                                   / scale["active_steps"])
    log(f"mesh scale: {json.dumps(scale)}")
    joint_scale = []
    for union in JOINT_SCALE_UNIONS:
        kins, feats, _, _ = joint_wave(bbase, big, union, rng, dev)
        res = joint_mesh_check(
            kins, feats, dev, MESH_SCALE_SHARDS,
            f"mesh joint scale/{union}/D={MESH_SCALE_SHARDS}", plain=False)
        res["union"] = union
        joint_scale.append(res)
        log(f"mesh joint scale {union}: {json.dumps(res)}")
    del big, bbase, members, kins

    # a card's rows past one cluster's shared memory: phase 4's waves at
    # N=524288 over D=4 on the one card (the sharded kernel refuses them,
    # and so did the joint sharded kernel of one cluster a card), through
    # launch_wave over the mesh: the joint sharded kernel over the
    # clusters its plan picks, the fused-envelope union (shuffle) too,
    # each mesh wave one counted fused fallback as the one-device wave is
    # (the CPU rehearsal's plain versions hold any width: it runs the
    # everything wave alone, at its own width)
    on_card = dev.type == "cuda"
    wide = c2m_cluster(MESH_WIDE_NODES, seed=SEED + 4)
    wc, wm, wd, _ = c2m_pack_usage(wide, MESH_WIDE_ALLOCS, seed=SEED + 4)
    wbase = base_kin(wide, (wc, wm, wd))
    joint_wide = []
    for union in CEILING_UNIONS if on_card else ("everything",):
        kins, feats, _, _ = joint_wave(wbase, wide, union, rng, dev)
        ctx = f"mesh joint wide/{union}/D={MESH_WIDE_SHARDS}"
        args = kernel_shards(kins, feats, dev, MESH_WIDE_SHARDS)
        n_loc = int(args[0][0].cap_cpu.shape[-1])
        check(not on_card or not ck.sharded_wave_fits(
            [dev] * MESH_WIDE_SHARDS, n_loc, int(args[0][0].n_steps.shape[0]),
            args[4].with_shuffle), f"{ctx}: the sharded kernel holds it")
        envelope = ck.fused_wave_supported(args[4])
        del args
        f0 = coalesce.fused_wave_stats.snapshot()
        res = joint_mesh_check(kins, feats, dev, MESH_WIDE_SHARDS, ctx,
                               plain=False)
        f1 = coalesce.fused_wave_stats.snapshot()
        check(f1["fallbacks"] - f0["fallbacks"] == 2
              and f1["launches"] == f0["launches"]
              and f1["failures"] == f0["failures"]
              and (not on_card or res["clusters_per_card"] > 1)
              and res["rows_shared"],
              f"{ctx}: fused stats {f0} -> {f1}, plan "
              f"{res['clusters_per_card']} clusters a card, rows in shared "
              f"memory {res['rows_shared']}")
        res.update(union=union, fused_envelope=envelope)
        joint_wide.append(res)
        log(f"mesh joint wide {union}: {json.dumps(res)}")
    del wide, wbase, kins

    # the real cards: one card makes a mesh of one device, which runs
    # the wave on it (B1), one counted fallback, as the reference's does
    cards = sharded.wave_mesh(device=dev)
    members = [make_member(base, cluster, "shuffle", rng)
               for _ in range(B_WAVE)]
    kins, feats = [m[0] for m in members], [m[1] for m in members]
    want, _, n0 = mesh_wave(kins, feats, dev, None)
    got, cards_ms, n1 = mesh_wave(kins, feats, dev, cards)
    b1 += n0["b1"] + n1["b1"]
    if cards.size < 2:
        check(n1 == dict(B1_WAVE, fallbacks=1),
              f"mesh/one card: launches {n1}")
        log(f"mesh: this host has {cards.size} card; its mesh fell back "
            "to B1, one counted fallback")
    else:
        check(n1 == dict(KERNEL_WAVE, clusters=cards.size),
              f"mesh/{cards.size} cards: launches {n1}")
    real = compare_waves(got, want, f"mesh/cards/D={cards.size}",
                         exact=True)
    real.update(cards=cards.size, ms=cards_ms, launches=n1)
    if cards.size >= 2:
        # the kernel alone over the cards, beside B1's on the first
        args = kernel_shards(kins, feats, dev, 0, list(cards.devices.flat))
        ck.sharded_wave_place(*args)
        real["kernel_ms"] = cuda_ms(lambda: ck.sharded_wave_place(*args), 10)
        real["b1_kernel_ms"] = b1_kernel_ms(kins, feats, dev)
        real["active_steps"] = sharded_active_steps(args)
        real["us_per_active_step"] = (real["kernel_ms"] * 1e3
                                      / real["active_steps"])
        # and the joint sharded kernel over the cards, beside the joint
        # kernel on the first
        kins, feats, _, _ = joint_wave(base, cluster, "everything", rng,
                                       dev)
        real["joint"] = joint_mesh_check(
            kins, feats, dev, cards.size,
            f"mesh joint/cards/D={cards.size}",
            devices=list(cards.devices.flat))
        # and at N=1048576, where each card takes several clusters
        wide = c2m_cluster(MESH_CARDS_WIDE_NODES, seed=SEED + 6)
        wc, wm, wd, _ = c2m_pack_usage(wide, MESH_CARDS_WIDE_ALLOCS,
                                       seed=SEED + 6)
        kins, feats, _, _ = joint_wave(base_kin(wide, (wc, wm, wd)), wide,
                                       "everything", rng, dev)
        ctx = f"mesh joint wide/cards/D={cards.size}"
        real["joint_wide"] = joint_mesh_check(
            kins, feats, dev, cards.size, ctx,
            devices=list(cards.devices.flat), plain=False)
        check(real["joint_wide"]["clusters_per_card"] > 1,
              f"{ctx}: {real['joint_wide']['clusters_per_card']} cluster a "
              "card")
        del wide, kins
    log(f"mesh cards: {json.dumps(real)}")
    joint_all = joint + joint_scale + joint_wide + [
        real[k] for k in ("joint", "joint_wide") if k in real]
    return {"per_d": [rows[d] for d in MESH_SHARDS], "cold": cold,
            "joint": joint, "joint_scale": joint_scale,
            "joint_wide": joint_wide, "scale": scale,
            "cards": real, "kernel": kernel, "b1_launches": b1,
            "near_ties": sum(r["near_ties"] for r in parity + kernel)
            + scale["near_ties"],
            "max_abs_err": max(r["max_abs_err"] for r in
                               parity + kernel + [scale, real]),
            "joint_max_abs_err": max(r["max_abs_err"] for r in joint_all),
            "variants": len(VARIANTS)}


def place_batch_bound(b: int, n_nodes: int, n_steps: int) -> dict:
    """``sharded.make_place_batch``'s bound at one shape, reckoned from
    its code (no main path runs it, so nothing is timed): each of ``b``
    evals reads every leaf of its KernelIn once (synthetic problems, half
    of them with a spread, as the multi-chip dry run builds them) and
    writes its KernelOut, and every step scores and selects over every
    node."""
    from nomad_tpu_torch.parallel.synthetic import synthetic_kernel_in

    k_pad = pad_steps(n_steps)
    kins = [synthetic_kernel_in(n_nodes=n_nodes, n_steps=n_steps,
                                with_spread=i % 2 == 0, used_frac=0.4,
                                seed=i) for i in range(b)]
    nbytes = sum(np.asarray(x).nbytes for kin in kins for x in kin)
    # chosen, scores, found, top-k indices and scores, eight metrics
    nbytes += b * (k_pad * (4 + 4 + 1 + 2 * 4 * 8) + 8 * 4)
    n_pad = int(np.asarray(kins[0].cap_cpu).shape[-1])
    ops = b * k_pad * n_pad * (OPS_PER_NODE_SCORE + OPS_PER_NODE_SELECT)
    bound_ms, bound_by = bound(nbytes, ops)
    return {"evals": b, "n_pad": n_pad, "k_pad": k_pad, "bytes": nbytes,
            "ops": ops, "bound_ms": bound_ms, "bound_by": bound_by}


def mesh_part_b(dev: torch.device, state, rng) -> dict:
    """Part B: the resident state split over a 4-shard mesh. Two waves
    of the store's own planes with alloc churn between them: the
    generation advances by the sharded scatter, equals a fresh upload
    split by shard, and the second wave finds every shared plane
    resident (0 B of them uploaded)."""
    mesh = sharded.wave_mesh(devices=[dev] * MESH_STATE_SHARDS)
    ds = default_device_state
    ds.configure_mesh(mesh)
    cache = coalesce.ClusterCache(dev)
    lookups = {"asked": 0, "resident": 0}
    real_lookup = ds.lookup

    def counted(arr, device=None, frozen_ok=True, spec=None, mesh=None):
        got = real_lookup(arr, device, frozen_ok, spec, mesh)
        if mesh is not None:
            lookups["asked"] += 1
            lookups["resident"] += got is not None
        return got

    masks: dict = {}

    def wave(tag: str) -> dict:
        # the store's wave-shared planes and a read-only base mask (one
        # per cluster build), held by every member by identity (the live
        # stack's shape)
        snap = state.snapshot()
        cluster = cache.get(snap)
        planes = cluster.wave_shared_planes(snap.usage)
        held, mask = masks.get(id(cluster), (None, None))
        if held is not cluster:
            mask = cluster.ready.copy()
            mask.setflags(write=False)
            masks[id(cluster)] = (cluster, mask)
        base = base_kin(cluster, (planes["used_cpu"], planes["used_mem"],
                                  planes["used_disk"]))._replace(
            base_mask=mask, **planes)
        members = [make_member(base, cluster, "lean", rng)
                   for _ in range(B_WAVE)]
        kins, feats = [m[0] for m in members], [m[1] for m in members]
        lookups.update(asked=0, resident=0)
        before = ds.snapshot()
        up0 = coalesce.upload_stats.bytes
        ds.lookup = counted
        try:
            got, ms, n = mesh_wave(kins, feats, dev, mesh)
        finally:
            del ds.lookup
        launcher = coalesce.upload_stats.bytes - up0
        after = ds.snapshot()
        check(n == KERNEL_WAVE, f"mesh state/{tag}: launches {n}")
        want, _, n = mesh_wave(kins, feats, dev, None)
        check(n["b1"] == 1, f"mesh state/{tag}: reference launches {n}")
        res = compare_waves(got, want, f"mesh state/{tag}", exact=True)
        fresh = ds.check_fresh(snap, dev)
        check(fresh["resident"] and fresh["differ"] == []
              and fresh["shards"] == MESH_STATE_SHARDS,
              f"mesh state/{tag}: resident shards against a fresh upload: "
              f"{fresh}")
        delta = {k: after[k] - before[k] for k in (
            "full_uploads", "delta_advances", "fork_deltas",
            "usage_full_uploads", "rows_uploaded", "bytes_uploaded")}
        return {"ms": ms, "launcher_bytes": launcher,
                "shared_lookups": lookups["asked"],
                "shared_resident": lookups["resident"],
                "state": delta, "max_abs_err": res["max_abs_err"],
                "resident_check": fresh}

    try:
        w1 = wave("first")
        live = [a for a in state.snapshot().allocs_iter()
                if not a.terminal_status()]
        pick = rng.choice(len(live), MESH_CHURN, replace=False)
        for i in pick:
            state.stop_alloc(live[int(i)].id, [])
        w2 = wave("after churn")
    finally:
        ds.configure_mesh(None)
    check(w1["shared_resident"] == w1["shared_lookups"] > 0,
          f"mesh state: the first wave's shared planes not all resident: "
          f"{w1}")
    check(w2["shared_resident"] == w2["shared_lookups"] > 0,
          f"mesh state: shared planes uploaded again: {w2}")
    st = w2["state"]
    check(st["delta_advances"] == 1 and st["full_uploads"] == 0
          and st["usage_full_uploads"] == 0 and st["fork_deltas"] == 0,
          f"mesh state: the churn did not advance by the scatter: {st}")
    # nothing but the dirty rows went up: each row's id and its value in
    # every usage plane, one int32 each
    fields = len(ClusterTensors.WAVE_USAGE_FIELDS)
    rows = st["rows_uploaded"] // fields
    check(0 < rows <= MESH_CHURN
          and st["bytes_uploaded"] == 4 * (1 + fields) * rows,
          f"mesh state: the second wave uploaded more than its rows: {st}")
    return {"shards": MESH_STATE_SHARDS, "churn": MESH_CHURN,
            "waves": [w1, w2], "b1_launches": 2, "scatter_rows": rows,
            "scatter_bytes": st["bytes_uploaded"]}


def mesh_part_c(dev: torch.device, srv, rng, window_off: dict) -> dict:
    """Part C: phase 11's window-off server over the restored state, its
    waves split over a 4-shard virtual mesh: the warm-up, then the timed
    burst, every count set to 0 just before it; then the spread arm,
    MESH_SPREAD_JOBS jobs spread over the datacenters, whose waves run the
    joint sharded kernel, with no torch-op wave."""
    from nomad_tpu_torch.telemetry.exporter import prometheus_text

    ctx = "mesh server"
    records: list = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("nomad_tpu_torch.server.server")
    keep = Keep(level=logging.INFO)
    level = logger.level
    logger.addHandler(keep)
    logger.setLevel(logging.INFO)
    # as in a fresh process, only the warmup makes a key seen
    profiler.clear_seen()
    kernel_warmup.warmup_stats.reset()
    try:
        srv.start()
    finally:
        logger.removeHandler(keep)
        logger.setLevel(level)
    res: dict = {"cards": torch.cuda.device_count() if dev.type == "cuda"
                 else 1}
    try:
        if res["cards"] < 2:
            check(srv.wave_mesh is None and any(
                "no mesh adopted" in m for m in records),
                f"{ctx}: use_device_mesh=True on one card: mesh "
                f"{srv.wave_mesh}, log {records}")
        res["probe_log"] = records
        mesh = sharded.wave_mesh(devices=[dev] * MESH_SERVER_SHARDS)
        srv._adopt_wave_mesh(mesh)
        check(srv.wave_mesh is mesh, f"{ctx}: mesh not adopted")
        # the warmup of part A's keys: the start-up pass and the mesh
        # pass of the mesh just adopted, both waited for
        t0 = time.perf_counter()
        for t in (srv._warmup_thread, srv._mesh_warmup_thread):
            check(t is not None, f"{ctx}: a warm pass did not start")
            t.join(timeout=WARMUP_WAIT_S)
            check(not t.is_alive(), f"{ctx}: warmup still running after "
                  f"{WARMUP_WAIT_S} s")
        res["kernel_warmup"] = dict(
            srv.warmup_stats or {"failed": 1}, wait_s=time.perf_counter() - t0,
            passes=srv.warmup_passes,
            launches=kernel_warmup.warmup_stats.snapshot())
        check(res["kernel_warmup"]["warmed"] >= 1
              and res["kernel_warmup"]["failed"] == 0,
              f"{ctx}: warmup {res['kernel_warmup']}")
        w = srv.workers[0]
        warm = [c2m.burst_job(rng, i, prefix="mesh-warm")
                for i in range(SERVER_WARMUP_JOBS)]
        profiler.reset()
        t0 = time.perf_counter()
        for job in warm:
            srv.job_register(job)
        res["warmup_s"] = server_converged(
            srv, warm, time.time() + SERVER_DEADLINE_S) - t0
        check_server_burst(srv, warm, f"{ctx} warm-up")
        res["warmup_jobs_sharded_misses"] = sharded_misses()

        jobs = [c2m.burst_job(rng, i, prefix="mesh-burst")
                for i in range(SERVER_JOBS)]
        histograms.get("e2e").reset()
        srv.plan_latencies.clear()
        coalesce.fused_wave_stats.reset()
        coalesce.sharded_wave_stats.reset()
        coalesce.wave_stats.reset()
        default_device_state.reset_stats()
        profiler.reset()
        waves0, requests0 = w.batch_launches, w.batch_requests
        ck.launches = 0
        ck.sharded_launches = 0
        c0 = cluster_launches()
        t0 = time.perf_counter()
        for job in jobs:
            srv.job_register(job)
        t_done = server_converged(srv, jobs,
                                  time.time() + SERVER_DEADLINE_S)
        burst_s = t_done - t0
        b1 = ck.launches
        kernel_calls = ck.sharded_launches
        clusters = cluster_launches() - c0
        misses = sharded_misses()
        sstats = coalesce.sharded_wave_stats.snapshot()
        fstats = coalesce.fused_wave_stats.snapshot()
        wstats = coalesce.wave_stats.snapshot()
        dstate = default_device_state.snapshot()
        e2e = histograms.get("e2e")
        e2e_p50, e2e_p99 = e2e.quantiles((0.5, 0.99))
        scrape = prometheus_values(prometheus_text())
        check_server_burst(srv, jobs, ctx)
        # the burst's waves, once its last chunk is reaped
        time.sleep(1.0)
        waves1, requests1 = w.batch_launches, w.batch_requests

        # the spread arm: jobs spread over the datacenters, whose waves
        # run the joint sharded kernel; its counts set to 0 just before
        # and read just after
        sjobs = [spread_burst_job(rng, i) for i in range(MESH_SPREAD_JOBS)]
        coalesce.fused_wave_stats.reset()
        coalesce.joint_wave_stats.reset()
        coalesce.sharded_wave_stats.reset()
        coalesce.wave_stats.reset()
        single_eval_stats.reset()
        ck.joint_sharded_launches = 0
        ck.launches = ck.sharded_launches = 0
        jc0 = joint_cluster_launches()
        t0 = time.perf_counter()
        for job in sjobs:
            srv.job_register(job)
        spread_s = server_converged(srv, sjobs,
                                    time.time() + SERVER_DEADLINE_S) - t0
        res["spread"] = {
            "jobs": MESH_SPREAD_JOBS, "burst_s": spread_s,
            "evals_per_s": MESH_SPREAD_JOBS / spread_s,
            "joint_sharded_calls": ck.joint_sharded_launches,
            "cluster_launches": joint_cluster_launches() - jc0,
            "b1": ck.launches, "sharded_kernel_calls": ck.sharded_launches,
            "joint": coalesce.joint_wave_stats.snapshot(),
            "fused": coalesce.fused_wave_stats.snapshot(),
            "sharded": coalesce.sharded_wave_stats.snapshot(),
            "wave_stats": coalesce.wave_stats.snapshot(),
            "single_evals": single_eval_stats.snapshot()}
        check_server_burst(srv, sjobs, f"{ctx} spread")
        # the spread arm's waves, once its last chunk is reaped
        time.sleep(1.0)
        res["spread"]["waves"] = w.batch_launches - waves1
        # where a burst's time goes: as many spread jobs again under the
        # tracer, then as many lean ones, each span's totals
        res["spread"]["traced"] = traced_burst(
            srv, [spread_burst_job(rng, i, "mesh-spread-traced")
                  for i in range(MESH_SPREAD_JOBS)], f"{ctx} traced spread")
        res["spread"]["traced_lean"] = traced_burst(
            srv, [c2m.burst_job(rng, i, prefix="mesh-lean-traced")
                  for i in range(MESH_SPREAD_JOBS)], f"{ctx} traced lean")
    finally:
        srv.shutdown()
    waves = waves1 - waves0
    requests = requests1 - requests0
    check(default_device_state.mesh is None,
          f"{ctx}: the resident state kept the server's mesh")
    check(sstats["launches"] == waves >= 1 and sstats["fallbacks"] == 0
          and sstats["mesh_devices"] == MESH_SERVER_SHARDS,
          f"{ctx}: sharded {sstats} for {waves} waves")
    check(fstats == {"launches": waves, "fallbacks": 0, "failures": 0},
          f"{ctx}: fused {fstats} for {waves} waves")
    check(b1 == 0, f"{ctx}: {b1} B1 launches in sharded waves")
    check(misses == 0, f"{ctx}: {misses} sharded misses in the timed burst "
          "after the warmup")
    check(kernel_calls == waves,
          f"{ctx}: {kernel_calls} sharded kernel calls for {waves} waves")
    check(clusters == waves,
          f"{ctx}: {clusters} cluster launches for {waves} waves on one "
          "card")
    check(dstate["errors"] == 0 and dstate["mesh_devices"]
          == MESH_SERVER_SHARDS, f"{ctx}: device state {dstate}")
    sp = res["spread"]
    check(sp["joint_sharded_calls"] >= 1
          and sp["joint"]["sharded_launches"] == sp["joint_sharded_calls"]
          == sp["cluster_launches"]
          and sp["joint"]["torch_waves"] == 0 and sp["b1"] == 0
          and sp["fused"]["failures"] == 0
          and sp["sharded"]["launches"] == sp["waves"]
          and sp["sharded"]["fallbacks"] == 0,
          f"{ctx} spread: {sp}")
    series = {k: scrape.get(f"nomad_tpu_wave_sharded_{k}") for k in (
        "launches_total", "fallbacks_total", "mesh_devices")}
    check(series == {"launches_total": waves, "fallbacks_total": 0,
                     "mesh_devices": MESH_SERVER_SHARDS},
          f"{ctx}: the exporter reads {series} for {waves} waves")
    res.update({
        "shards": MESH_SERVER_SHARDS, "evals": SERVER_JOBS,
        "burst_s": burst_s, "evals_per_s": SERVER_JOBS / burst_s,
        "e2e_p50_ms": e2e_p50 * 1e3, "e2e_p99_ms": e2e_p99 * 1e3,
        "waves": waves, "wave_fill": requests / waves if waves else 0.0,
        "wave_latency_p50_ms": wstats["wave_latency_p50_ms"],
        "wave_latency_p99_ms": wstats["wave_latency_p99_ms"],
        "assemble_latency_p50_ms": wstats["assemble_latency_p50_ms"],
        "sharded": sstats, "fused": fstats, "kernel_calls": kernel_calls,
        "cluster_launches": clusters, "sharded_misses": misses,
        "device_state": {k: dstate[k] for k in (
            "hits", "delta_advances", "full_uploads", "rows_uploaded",
            "bytes_uploaded", "errors", "mesh_devices")},
        "exporter": series,
        "window_off_evals_per_s": window_off.get("evals_per_s"),
        "window_off_wave_p50_ms": window_off.get("wave_latency_p50_ms"),
    })
    return res


def run_mesh_phase(dev: torch.device, record: dict, state_bytes: bytes,
                   window_off: dict, server_entries: list) -> dict:
    """Phase 17: parts A, B and C; one ``mesh: {...}`` line. Part C's
    server warms the keys part A launched and ``server_entries``, the
    manifest a server of its shape persisted in a warm start's run A
    (part A's synthetic waves take other layouts and feature unions than
    a server's)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    coalesce.sharded_wave_stats.reset()
    # the profiler records part A's keys: part C's server warms them
    profiler.enable()
    profiler.reset()
    try:
        part_a = mesh_part_a(dev, rng)
        entries = kernel_warmup.manifest_from_profiler() + list(
            server_entries)
        with tempfile.TemporaryDirectory(prefix="mesh_manifest_") as tmp:
            manifest = str(Path(tmp) / "warmup.json")
            kernel_warmup.save_manifest(entries, manifest)
            srv = Server(ServerConfig(
                num_workers=1, worker_batch_size=SERVER_BATCH,
                heartbeat_ttl=3600.0, gc_tuning=True, coalesce_adaptive=False,
                use_device_mesh=True, kernel_warmup=True,
                warmup_manifest_path=manifest), device=dev)
            t0 = time.perf_counter()
            srv.state.restore_from_bytes(state_bytes)
            restore_s = time.perf_counter() - t0
            part_b = mesh_part_b(dev, srv.state, rng)
            part_c = mesh_part_c(dev, srv, rng, window_off)
    finally:
        profiler.disable()
        profiler.reset()
    part_c["restore_s"] = restore_s
    part_c["manifest_entries"] = len(entries)
    part_c["server_manifest_entries"] = len(server_entries)
    timed = next(r for r in part_a["kernel"] if "ms" in r)
    per_d = {r["shards"]: r for r in part_a["per_d"]}
    ratio = (per_d[MESH_KERNEL_SHARDS]["ms_median"]
             / per_d[MESH_KERNEL_SHARDS]["b1_ms_median"])
    # the sharded kernel's entry of the kernels' JSON line: its calls in
    # part C's timed burst (the main path), its times at D=4
    scale = part_a["scale"]
    entry = {
        "name": "sharded_wave_place",
        "route": "cuda",
        "source": "nomad_tpu_torch/csrc/sharded_wave.cu",
        "replaces": "nomad_tpu/parallel/sharded.py:291",
        "launches": part_c["kernel_calls"],
        "max_abs_err": part_a["max_abs_err"],
        "ms": timed["ms"],
        "plain_ms": timed["plain_ms"],
        "bound_ms": per_d[MESH_KERNEL_SHARDS]["bound_ms"],
        "bound_by": per_d[MESH_KERNEL_SHARDS]["bound_by"],
        "library_ms": None,
        "shards": MESH_KERNEL_SHARDS,
        # B1's kernel on the same wave in this call, the kernel launches
        # (one a card a wave) in part C's timed burst, the time an active
        # step
        "b1_ms": timed["b1_ms"],
        "cluster_launches": part_c["cluster_launches"],
        "cluster_launches_per_wave": (part_c["cluster_launches"]
                                      / part_c["waves"]),
        "active_steps": timed["active_steps"],
        "us_per_active_step": timed["us_per_active_step"],
        "ms_per_d": timed["ms_per_d"],
        "b1_ms_per_d": timed["b1_ms_per_d"],
        "scale_ms": scale["kernel_ms"],
        "scale_b1_ms": scale["b1_kernel_ms"],
        "scale_us_per_active_step": scale["us_per_active_step"],
    }
    # the joint sharded kernel's entry: its calls in part C's spread arm
    # (the main path), the spread wave's times at D=4, every union's and
    # the scale waves' beside
    jspread = next(r for r in part_a["joint"] if r["union"] == "spread")
    jentry = {
        "name": "joint_sharded_wave_place",
        "route": "cuda",
        "source": "nomad_tpu_torch/csrc/joint_sharded_wave.cu",
        "replaces": "nomad_tpu/parallel/sharded.py:207",
        "launches": part_c["spread"]["joint_sharded_calls"],
        "max_abs_err": part_a["joint_max_abs_err"],
        "ms": jspread["kernel_ms"],
        "plain_ms": jspread["plain_ms"],
        "bound_ms": jspread["bound_ms"],
        "bound_by": jspread["bound_by"],
        "library_ms": None,
        "shards": MESH_SPREAD_SHARDS,
        "joint_ms": jspread["joint_ms"],
        "cluster_launches": part_c["spread"]["cluster_launches"],
        "active_steps": jspread["active_steps"],
        "us_per_active_step": jspread["us_per_active_step"],
        "union_ms": {r["union"]: r["kernel_ms"] for r in part_a["joint"]},
        "union_joint_ms": {r["union"]: r["joint_ms"]
                           for r in part_a["joint"]},
        "union_plain_ms": {r["union"]: r["plain_ms"]
                           for r in part_a["joint"]},
        "union_bound_ms": {r["union"]: r["bound_ms"]
                           for r in part_a["joint"]},
        "union_launch_wave_ms": {r["union"]: r["launch_wave_ms"]
                                 for r in part_a["joint"]},
        "scale_ms": {r["union"]: r["kernel_ms"]
                     for r in part_a["joint_scale"]},
        "scale_joint_ms": {r["union"]: r["joint_ms"]
                           for r in part_a["joint_scale"]},
        "scale_bound_ms": {r["union"]: r["bound_ms"]
                           for r in part_a["joint_scale"]},
        # N=524288 on the one card (D=4), past one cluster's shared
        # memory, beside the joint kernel on the same wave
        "wide_ms": {r["union"]: r["kernel_ms"] for r in part_a["joint_wide"]},
        "wide_joint_ms": {r["union"]: r["joint_ms"]
                          for r in part_a["joint_wide"]},
        "wide_bound_ms": {r["union"]: r["bound_ms"]
                          for r in part_a["joint_wide"]},
        # the plan's clusters a card of every wave checked
        "clusters": {f"{r['union']}@{r['n_pad']}/D={r['shards']}":
                     r["clusters_per_card"]
                     for r in part_a["joint"] + part_a["joint_scale"]
                     + part_a["joint_wide"]},
    }
    for key, name in (("joint", "cards"), ("joint_wide", "cards_wide")):
        if key in part_a["cards"]:
            jentry[f"{name}_ms"] = part_a["cards"][key]["kernel_ms"]
            jentry[f"{name}_joint_ms"] = part_a["cards"][key]["joint_ms"]
            jentry[f"{name}_clusters"] = \
                part_a["cards"][key]["clusters_per_card"]
    log(f"mesh joint kernel: " + ", ".join(
        f"{u} {jentry['union_ms'][u]:.3f} ms (joint "
        f"{jentry['union_joint_ms'][u]:.3f}, plain "
        f"{jentry['union_plain_ms'][u]:.1f})" for u in jentry["union_ms"])
        + f" at D={MESH_SPREAD_SHARDS}; N=131072 at D={MESH_SCALE_SHARDS} "
        + ", ".join(f"{u} {ms:.3f} ms" for u, ms in
                    jentry["scale_ms"].items())
        + f"; N=524288 at D={MESH_WIDE_SHARDS} "
        + ", ".join(f"{u} {ms:.3f} ms (joint "
                    f"{jentry['wide_joint_ms'][u]:.3f})"
                    for u, ms in jentry["wide_ms"].items())
        + f"; clusters a card {json.dumps(jentry['clusters'])}"
        + f"; part C's spread arm {part_c['spread']['joint_sharded_calls']} "
        f"calls in {part_c['spread']['waves']} waves, "
        f"{part_c['spread']['evals_per_s']:.1f} evals/s")
    # the joint sharded kernel on the sharded kernel's own waves: the
    # time each envelope wave would take if every mesh wave ran it
    lean = {r["variant"]: r["lean_joint"] for r in part_a["kernel"]}
    ratios = [x["joint_ms"] / x["sharded_ms"] for rows in lean.values()
              for x in rows]
    log("mesh lean waves, joint sharded / sharded kernel ms: " + "; ".join(
        f"{v} " + ", ".join(f"D={x['shards']} {x['joint_ms']:.3f}/"
                            f"{x['sharded_ms']:.3f}" for x in rows)
        for v, rows in lean.items())
        + f"; ratio {min(ratios):.3f}-{max(ratios):.3f}")
    log(f"mesh kernel: {timed['ms']:.3f} ms a live wave at "
        f"D={MESH_KERNEL_SHARDS} ({MESH_TIMED_VARIANT}; B1 "
        f"{timed['b1_ms']:.3f} ms), {timed['us_per_active_step']:.2f} us "
        f"an active step of {timed['active_steps']}, "
        f"{entry['cluster_launches_per_wave']:g} kernel launch a wave in "
        f"the server burst, plain "
        f"{timed['plain_ms']:.1f} ms; at D = {list(MESH_SHARDS)} "
        f"{[round(timed['ms_per_d'][d], 3) for d in MESH_SHARDS]} ms "
        f"(B1 {[round(timed['b1_ms_per_d'][d], 3) for d in MESH_SHARDS]}); "
        f"N={scale['n_pad']} at D={MESH_SCALE_SHARDS} "
        f"{scale['kernel_ms']:.3f} ms (B1 {scale['b1_kernel_ms']:.3f}); "
        f"launch_wave at D={MESH_KERNEL_SHARDS} {ratio:.2f}x B1's")
    res = {
        "per_d": [{k: r[k] for k in (
            "shards", "waves", "sharded_launches", "ms_median",
            "b1_ms_median", "max_abs_err", "near_ties", "bound_ms",
            "bound_by", "ms", "b1_ms")} for r in part_a["per_d"]],
        "cold": part_a["cold"], "joint": part_a["joint"],
        "joint_scale": part_a["joint_scale"],
        "joint_wide": part_a["joint_wide"],
        "scale": part_a["scale"], "cards": part_a["cards"],
        "near_ties": part_a["near_ties"], "kernel": part_a["kernel"],
        "kernel_entry": entry, "joint_kernel_entry": jentry,
        "lean_joint": lean, "lean_joint_ratio": [min(ratios), max(ratios)],
        "launch_wave_ratio_d4": ratio,
        # the multi-chip dry run's shape (__graft_entry__.dryrun_multichip
        # at 8 devices) and the live wave's
        "place_batch_bound": [place_batch_bound(4, 256, 4),
                              place_batch_bound(B_WAVE, MESH_LIVE_NODES,
                                                K_PLACE)],
        "b1_launches": part_a["b1_launches"] + part_b["b1_launches"],
        "state": part_b, "server": part_c,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"mesh: {json.dumps(res)}")
    record["mesh"] = res
    return res


def run_mesh_warm_start(state_bytes: bytes, device: str = "cuda",
                        n_jobs: int = SERVER_JOBS) -> tuple:
    """``--mesh-phase``'s warm start: phase 12's three fresh processes
    (``warm_start_child`` with ``mesh``) from the same snapshot bytes and
    one manifest, each a server whose waves run over a mesh. Run A is
    cold and persists the manifest; run B waits for its warmup, run C
    bursts at once. Gates: B and C fail no warm entry and warm at least
    one sharded key; B misses no sharded key in its probe or its burst;
    B places the probe jobs as A does; each child's own gates (every job
    placed, none over capacity, every wave sharded, no B1 launch, 0
    fallbacks, failures and device-state errors). One line a run.
    Returns the runs and the manifest's entries."""
    runs = []
    with tempfile.TemporaryDirectory(prefix="mesh_warm_start_") as tmp:
        state_path = Path(tmp) / "state.bin"
        state_path.write_bytes(state_bytes)
        manifest = Path(tmp) / "warmup.json"
        for run in ("A", "B", "C"):
            check((run != "A") == manifest.exists(),
                  f"mesh warm start {run}: manifest exists="
                  f"{manifest.exists()}")
            out = Path(tmp) / f"run{run}.json"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--warm-start", run, str(state_path), str(manifest),
                     str(out), "--mesh", "--device", device, "--jobs",
                     str(n_jobs)], capture_output=True, text=True,
                    timeout=WARM_CHILD_TIMEOUT_S,
                    cwd=str(Path(__file__).resolve().parent),
                    # one string-hash seed for every run: the order of a
                    # set of strings, which the scheduler's choices reach,
                    # is then the same in each
                    env=dict(os.environ, PYTHONHASHSEED="0"))
            except subprocess.TimeoutExpired:
                fail(f"mesh warm start {run}: over {WARM_CHILD_TIMEOUT_S} s")
            for line in proc.stdout.splitlines():
                log(f"mesh warm start {run}: {line}")
            check(proc.returncode == 0,
                  f"mesh warm start {run} failed (exit {proc.returncode}): "
                  f"{proc.stderr[-3000:]}")
            res = json.loads(out.read_text())
            res["process_s"] = time.perf_counter() - t0
            runs.append(res)
        entries = kernel_warmup.load_manifest(str(manifest))
    a, b, c = runs
    check(a["warmup"]["warmed"] == 0 and a["warmup"]["failed"] == 0,
          f"mesh warm start A warmed {a['warmup']}")
    for r in (b, c):
        launches = r["warmup"]["launches"]
        check(r["warmup"]["failed"] == 0
              and launches.get("fused_wave_sharded", 0)
              + launches.get("joint_sharded", 0) >= 1,
              f"mesh warm start {r['run']}: warmup {r['warmup']}")
    check(b["probe"]["sharded_misses"] == 0
          and b["burst_sharded_misses"] == 0,
          f"mesh warm start B: sharded misses: probe "
          f"{b['probe']['per_key']}, burst {b['burst_profile']['PerKey']}")
    placed = a["probe"]["placements"]
    check(len(placed) == PROBE_JOBS * c2m.BURST_COUNT
          and b["probe"]["placements"] == placed,
          f"mesh warm start: B placed the probe jobs unlike A "
          f"({sum(b['probe']['placements'].get(k) != v for k, v in placed.items())}"
          f" of {len(placed)} allocs differ)")
    for r in runs:
        line = {k: r[k] for k in (
            "run", "start_to_first_wave_s", "first_wave_latency_ms",
            "first_launch_wave_ms", "burst_launch_wave_warm_median_ms",
            "burst_sharded_misses", "evals_per_s", "waves")}
        line["warmup"] = {k: r["warmup"].get(k) for k in (
            "warmed", "failed", "seconds", "wait_s", "passes", "launches")}
        line["probe_sharded_misses"] = r["probe"].get("sharded_misses")
        log(f"mesh warm start: {json.dumps(line)}")
    return runs, entries


# ---------------------------------------------------------------------------
# Phase 18: the batched placement step over an (evals, nodes) mesh.
# ---------------------------------------------------------------------------

PB_EVALS = B_WAVE              # evals a batch (a worker batch's 32)
PB_NODES = MESH_LIVE_NODES     # 10,000 nodes: N=16384, c2m's width
PB_PLACE = K_PLACE             # placements an eval (k_pad 16)
PB_MESH = (2, 4)               # evals x nodes, virtual on one card
PB_CARDS_MESH = (2, 2)         # over four cards (--mesh-phase)
PB_B1_MESH = (2, 1)            # rows of one node shard: B1
PB_REPEATS = 3                 # timed calls of the routed step (lean)


def place_batch_kins(n_evals: int, mix: bool) -> list:
    """A batch of independent problems as the multi-chip dry run builds
    them at full width (``place_batch_bound``'s): ``mix`` puts a spread
    on every even eval, else every eval is lean."""
    from nomad_tpu_torch.parallel.synthetic import synthetic_kernel_in

    return [synthetic_kernel_in(n_nodes=PB_NODES, n_steps=PB_PLACE,
                                with_spread=mix and i % 2 == 0,
                                used_frac=0.4, seed=i)
            for i in range(n_evals)]


def place_batch_counts() -> dict:
    """B1's, the joint kernel's, the sharded kernel's and the joint
    sharded kernel's calls so far, the two sharded kernels' cluster
    launches, and the step's route counts."""
    return {"b1": ck.launches, "joint": ck.joint_launches,
            "kernel": ck.sharded_launches,
            "joint_sharded": ck.joint_sharded_launches,
            "clusters": cluster_launches(),
            "joint_clusters": joint_cluster_launches(),
            **sharded.place_batch_stats.snapshot()}


def place_batch_check(name: str, stacked, mesh, dev,
                      repeats: int = PB_REPEATS) -> dict:
    """One batch through the routed step and the plain step on ``mesh``:
    every eval held against the plain step's (i32 outputs exact, scores
    within ATOL, near-ties counted apart), the routed step's CUDA-event
    ms (``repeats`` calls) beside the plain step's (one call) and beside
    placing the batch's leaves alone (its upload, part of every call)."""
    k_pad = pad_steps(PB_PLACE)
    place_ms = event_ms(lambda: sharded.place_args(
        stacked, sharded.batched_in_shardings(mesh)))[1]
    routed = sharded.make_place_batch(mesh, k_pad)
    plain = sharded.make_place_batch(mesh, k_pad, plain=True)
    got = sharded.unstack_kernel_outs(routed(stacked))
    want_out, plain_ms = event_ms(lambda: plain(stacked))
    want = sharded.unstack_kernel_outs(want_out)
    errs, near_ties, placed = [], 0, 0
    for e, (g, w) in enumerate(zip(got, want)):
        res = compare_waves([g], [w], f"place batch {name} eval {e}")
        errs.append(res["max_abs_err"])
        near_ties += res["near_ties"]
        placed += res["placed"]
    ms = sorted(event_ms(lambda: routed(stacked))[1]
                for _ in range(repeats))
    return {"batch": name, "mesh": dict(mesh.shape),
            "evals": len(got), "placed": placed,
            "max_abs_err": max(errs), "near_ties": near_ties,
            "ms": ms, "ms_median": ms[len(ms) // 2], "plain_ms": plain_ms,
            "place_ms": place_ms}


def run_place_batch_phase(dev: torch.device, record: dict,
                          cards: list = None) -> dict:
    """Phase 18: ``entry.dryrun_multichip(8)`` over eight virtual
    positions of the card (or ``dryrun_multichip(4)`` over ``cards``),
    then ``sharded.make_place_batch`` at full width: the dry run's mix
    and an all-lean batch over ``PB_MESH`` (``PB_CARDS_MESH`` over
    ``cards``), where every eval in the envelope is one call of the
    sharded kernel and every spread eval one call of the joint sharded
    kernel, and the all-lean batch and the mix over ``PB_B1_MESH``, where
    a lean eval is one call of B1 and a spread eval one call of the joint
    kernel. The counts are set to 0 just before the four batches' first
    routed calls (the main path) and read just after: each eval one
    kernel call and no plain eval, one cluster launch a card a sharded
    call. Each batch is then held against the plain step and timed beside
    it. One ``place batch: {...}`` line."""
    from nomad_tpu_torch import entry

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    if cards:
        dry = entry.dryrun_multichip(len(cards), devices=cards)
    else:
        dry = entry.dryrun_multichip(8, devices=[dev] * 8)
    dry_s = time.perf_counter() - t0
    check(dry["routes"]["kernel_calls"] == dry["batch"]
          and dry["routes"]["plain_evals"] == 0,
          f"place batch: the dry run's routes {dry['routes']}")
    log(f"place batch: dry run over {dry['mesh']} in {dry_s:.1f} s: "
        f"routes {dry['routes']}, {dry['placed']} live allocs, "
        f"{dry['sharded_waves']} sharded waves")

    def mesh_of(shape, devices):
        n = shape[0] * shape[1]
        return pmesh.make_mesh(n, evals_parallel=shape[0],
                               devices=devices[:n])

    if cards:
        main_mesh = mesh_of(PB_CARDS_MESH, cards)
        b1_mesh = mesh_of(PB_B1_MESH, cards)
    else:
        main_mesh = mesh_of(PB_MESH, [dev] * 8)
        b1_mesh = mesh_of(PB_B1_MESH, [dev] * 2)
    # the cards one sharded call spans: one evals row's
    n_cards = len({main_mesh.devices.flat[p]
                   for p in main_mesh.node_rows()[0]})
    mix = sharded.stack_kernel_ins(place_batch_kins(PB_EVALS, True))
    lean = sharded.stack_kernel_ins(place_batch_kins(PB_EVALS, False))
    batches = (("mix", mix, main_mesh), ("lean", lean, main_mesh),
               ("lean_b1", lean, b1_mesh), ("mix_b1", mix, b1_mesh))
    k_pad = pad_steps(PB_PLACE)
    steps = {n: sharded.make_place_batch(m, k_pad) for n, _, m in batches}
    torch.cuda.synchronize()
    # the main path: the three batches' first routed calls
    drive = {}
    for name, stacked, _ in batches:
        a = place_batch_counts()
        steps[name](stacked)
        torch.cuda.synchronize()
        b = place_batch_counts()
        drive[name] = {k: b[k] - a[k] for k in b}
    launches = {k: sum(d[k] for d in drive.values()) for k in a}
    half = PB_EVALS // 2
    # rows of several shards: the spread evals through the joint sharded
    # kernel; rows of one: through the joint kernel
    want = {"mix": {"b1": 0, "joint": 0, "kernel": half,
                    "joint_sharded": half, "plain_evals": 0},
            "lean": {"b1": 0, "joint": 0, "kernel": PB_EVALS,
                     "joint_sharded": 0, "plain_evals": 0},
            "lean_b1": {"b1": PB_EVALS, "joint": 0, "kernel": 0,
                        "joint_sharded": 0, "plain_evals": 0},
            "mix_b1": {"b1": half, "joint": half, "kernel": 0,
                       "joint_sharded": 0, "plain_evals": 0}}
    for name, counts in drive.items():
        got = {k: counts[k] for k in want[name]}
        check(got == want[name],
              f"place batch {name}: launches {counts}, want {want[name]}")
        check(counts["clusters"] == counts["kernel"] * n_cards
              and counts["joint_clusters"]
              == counts["joint_sharded"] * n_cards,
              f"place batch {name}: {counts['clusters']} / "
              f"{counts['joint_clusters']} cluster launches for "
              f"{counts['kernel']} / {counts['joint_sharded']} sharded and "
              f"joint sharded calls over {n_cards} cards")
    checks = [place_batch_check(n, x, m, dev) for n, x, m in batches]
    pb = place_batch_bound(PB_EVALS, PB_NODES, PB_PLACE)
    res = {
        "dry_run": {k: v for k, v in dry.items() if k != "outs"},
        "dry_run_s": dry_s, "cards": n_cards, "drive": drive,
        "launches": launches, "batches": checks,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "near_ties": sum(c["near_ties"] for c in checks),
        "bound_ms": pb["bound_ms"], "bound_by": pb["bound_by"],
        "bound": pb, "phase_s": time.perf_counter() - t_phase,
    }
    for c in checks:
        log(f"place batch {c['batch']} over {c['mesh']}: "
            f"{c['ms_median']:.3f} ms a batch of {c['evals']} (routed, "
            f"median of {len(c['ms'])}; placing its leaves "
            f"{c['place_ms']:.3f} ms) beside {c['plain_ms']:.1f} ms plain; "
            f"{drive[c['batch']]['kernel_calls']} kernel calls, "
            f"{drive[c['batch']]['plain_evals']} plain evals; max abs err "
            f"{c['max_abs_err']}, {c['near_ties']} near-ties; bound "
            f"{pb['bound_ms'] * 1e3:.1f} us ({pb['bound_by']})")
    log(f"place batch: {json.dumps(res)}")
    record["place_batch"] = res
    return res


def place_batch_alone(argv: list) -> int:
    """``chip_smoke.py --place-batch-phase``: phase 18 alone on the card,
    over four cards (mesh (2, 2), the dry run at 4) when the host has
    four or more, else over the one card's virtual positions. Builds the
    kernels first; prints the card's line; writes
    chiprun_out/place_batch_phase.json."""
    if argv:
        print(f"chip_smoke: --place-batch-phase takes no arguments, got "
              f"{argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: --place-batch-phase needs an NVIDIA card",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    ck.load_libraries()
    cards = ([torch.device("cuda", i) for i in range(4)]
             if torch.cuda.device_count() >= 4 else None)
    res = run_place_batch_phase(torch.device("cuda"), {}, cards)
    res["card"] = card
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "place_batch_phase.json").write_text(json.dumps(res,
                                                               indent=1))
    return 0


def mesh_phase_alone(argv: list) -> int:
    """``chip_smoke.py --mesh-phase [--device cpu] [--nodes N] [--allocs
    M]``: the warm start over a mesh (``run_mesh_warm_start``), phase
    11's window-off arm, then phase 17, on the state of
    ``c2m.generate(N, M)`` (10,000 nodes and 100k allocs unless given),
    then phase 18 (over four cards when the host has four or more;
    ``--nodes`` also sizes its batches on the CPU).
    On the card the kernels are built first. ``--device cpu`` rehearses
    it on the CPU at the cluster sizes given (``--nodes`` also sizes part
    A's clusters), with host-clock times and B1's and the sharded
    kernel's plain versions counted as their launches."""
    import argparse
    from unittest import mock as patch

    ap = argparse.ArgumentParser(prog="chip_smoke.py --mesh-phase")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nodes", type=int, default=c2m.N_NODES)
    ap.add_argument("--allocs", type=int, default=c2m.N_ALLOCS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: --mesh-phase needs an NVIDIA card; --device cpu "
              "rehearses it", file=sys.stderr)
        return 2
    if os.environ.pop("NOMAD_TPU_GC_TUNING", None) is not None:
        log("mesh phase: NOMAD_TPU_GC_TUNING was set; unset")
    kernel_warmup.DEFAULT_MANIFEST_PATH = str(
        Path(__file__).resolve().parent / "build" / "no_manifest.json")
    dev = torch.device(args.device)
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        log(f"card: {card}")
        ck.load_libraries()
    t0 = time.perf_counter()
    state_bytes = c2m.generate(args.nodes, args.allocs).to_snapshot_bytes()
    log(f"mesh phase: state of {args.nodes} nodes in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 11)
    # the warm start first: its run A's manifest holds the server's keys,
    # which part C's server warms as the full smoke's takes phase 12's
    warm_start, server_entries = run_mesh_warm_start(
        state_bytes, args.device,
        SERVER_JOBS if args.device == "cuda" else SERVER_WARMUP_JOBS)

    def run() -> dict:
        arm = server_arm(dev, state_bytes, True, False, SERVER_JOBS, rng)
        log(f"server: {json.dumps(arm)}")
        return run_mesh_phase(dev, {}, state_bytes, arm, server_entries)

    if args.device == "cuda":
        res = run()
        res["warm_start"] = warm_start
        n = torch.cuda.device_count()
        cards = ([torch.device("cuda", i) for i in range(4)] if n >= 4
                 else None)
        res["place_batch"] = run_place_batch_phase(dev, {}, cards)
        res["kernel_entry"]["place_batch_launches"] = \
            res["place_batch"]["launches"]["kernel"]
        res["joint_kernel_entry"]["place_batch_launches"] = \
            res["place_batch"]["launches"]["joint_sharded"]
        out_dir = Path(__file__).resolve().parent / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "mesh_phase.json").write_text(json.dumps(res, indent=1))
        print(json.dumps({"kernels": [res["kernel_entry"],
                                      res["joint_kernel_entry"]]}))
        return 0
    # the CPU rehearsal: the kernels' plain versions counted as their
    # launches, host-clock times, the scale wave at ten times the live
    # size
    plain = ck.fused_wave_place
    plain_sharded = ck.sharded_wave_place
    plain_joint = ck.joint_wave_place
    plain_joint_sharded = ck.joint_sharded_wave_place

    def counted(*a, **k):
        ck.launches += 1
        return plain(*a, **k)

    def counted_joint(*a, **k):
        ck.joint_launches += 1
        return plain_joint(*a, **k)

    clusters = [0, 0]

    def counted_sharded(*a, **k):
        ck.sharded_launches += 1
        clusters[0] += len({s.cap_cpu.device for s in a[0]})
        return plain_sharded(*a, **k)

    def counted_joint_sharded(*a, **k):
        ck.joint_sharded_launches += 1
        clusters[1] += len({s.cap_cpu.device for s in a[0]})
        return plain_joint_sharded(*a, **k)

    def joint_stats_note(kernel, sharded=False, global_rows=False):
        # the plain versions stand in for the kernels: count them so
        real_note(True, sharded, global_rows)

    real_note = coalesce.joint_wave_stats.note

    def host_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    global MESH_LIVE_NODES, MESH_LIVE_ALLOCS, MESH_SCALE_NODES
    global MESH_SCALE_ALLOCS, PB_NODES, MESH_WIDE_NODES, MESH_WIDE_ALLOCS
    MESH_LIVE_NODES, MESH_LIVE_ALLOCS = args.nodes, args.allocs
    PB_NODES = args.nodes
    MESH_SCALE_NODES, MESH_SCALE_ALLOCS = 10 * args.nodes, 10 * args.allocs
    MESH_WIDE_NODES, MESH_WIDE_ALLOCS = 30 * args.nodes, 10 * args.allocs
    with patch.patch.object(ck, "fused_wave_place", counted), \
            patch.patch.object(coalesce, "fused_wave_place", counted), \
            patch.patch.object(ck, "sharded_wave_place", counted_sharded), \
            patch.patch.object(sharded, "sharded_wave_place",
                               counted_sharded), \
            patch.patch.object(sharded, "fused_wave_place", counted), \
            patch.patch.object(ck, "joint_wave_place", counted_joint), \
            patch.patch.object(coalesce, "joint_wave_place",
                               counted_joint), \
            patch.patch.object(sharded, "joint_wave_place", counted_joint), \
            patch.patch.object(ck, "joint_sharded_wave_place",
                               counted_joint_sharded), \
            patch.patch.object(sharded, "joint_sharded_wave_place",
                               counted_joint_sharded), \
            patch.patch.object(coalesce.joint_wave_stats, "note",
                               joint_stats_note), \
            patch.patch(f"{__name__}.event_ms", host_ms), \
            patch.patch(f"{__name__}.cluster_launches",
                        lambda: clusters[0]), \
            patch.patch(f"{__name__}.joint_cluster_launches",
                        lambda: clusters[1]), \
            patch.patch(f"{__name__}.cuda_ms",
                        lambda fn, reps: host_ms(fn)[1]), \
            patch.patch.object(torch.cuda, "synchronize", lambda *a: None):
        run()
        run_place_batch_phase(dev, {})
    return 0

if __name__ == "__main__":
    sys.exit(main())
