"""Exposition: Prometheus text + JSON trace dump.

The reference serves go-metrics through ``/v1/metrics`` with
``?format=prometheus`` rendering the Prometheus text exposition
(command/agent/http.go:383). This exporter extends that surface with
the telemetry subsystem's series:

- ``nomad_tpu_trace_span_seconds_total{span=...}`` /
  ``..._exclusive_seconds_total`` / ``..._count`` — per-span-name
  aggregates from the tracer (full-fidelity; survives ring wrap).
- ``nomad_tpu_kernel_stage_seconds_total{stage=...}`` — the wave
  pipeline decomposition (h2d / compile / dispatch / execute).
- ``nomad_tpu_kernel_jit_cache_misses_total{kernel=...,key=...}`` and
  ``..._launches_total`` — the first-launch accounting per bucket shape.

Every source the exposition reads exists in this package, so a source
that fails, or lacks a key, raises here instead of dropping its series.

``traces_json`` is the ``/v1/operator/traces`` body: the raw span ring
(newest spans, bounded) plus the aggregates, so an operator can pull a
decomposition from a live server without restarting it.
"""

from __future__ import annotations

from typing import Dict, List

from nomad_tpu_torch.telemetry.histogram import histograms
from nomad_tpu_torch.telemetry.kernel_profile import profiler
from nomad_tpu_torch.telemetry.trace import (
    consensus_recorder,
    flight_recorder,
    tracer,
)
from nomad_tpu_torch.utils import metrics as _metrics


def _esc(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, AND newline
    (the text exposition is line-framed — an unescaped newline in a
    label value corrupts every series after it). The exporter routes every
    labeled series through this one helper (via :func:`_lbl`); server
    ids and trace ids now flow into labels, so hygiene is load-bearing
    rather than cosmetic."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _lbl(**kv) -> str:
    """Render ``k="v"`` label pairs, every value escaped. The single
    seam all labeled series go through."""
    return ",".join(f'{k}="{_esc(v)}"' for k, v in kv.items())


def prometheus_text(registry=None, event_broker=None) -> str:
    """The full exposition: metrics registry + telemetry series.
    ``event_broker`` is the serving server's broker (per-server state,
    unlike every other source here); the HTTP layer passes it so the
    ``nomad_tpu_stream_*`` gauges ride the same scrape."""
    reg = registry if registry is not None else _metrics.global_registry
    base = reg.prometheus_text().strip("\n")
    lines: List[str] = [base] if base else []

    stages = tracer.stage_totals()
    if stages:
        lines.append("# TYPE nomad_tpu_trace_span_seconds_total counter")
        for name, agg in stages.items():
            lines.append(
                f'nomad_tpu_trace_span_seconds_total{{{_lbl(span=name)}}} '
                f"{agg['total_s']:.6f}")
        lines.append(
            "# TYPE nomad_tpu_trace_span_exclusive_seconds_total counter")
        for name, agg in stages.items():
            lines.append(
                f'nomad_tpu_trace_span_exclusive_seconds_total'
                f'{{{_lbl(span=name)}}} '
                f"{agg['exclusive_s']:.6f}")
        lines.append("# TYPE nomad_tpu_trace_span_count counter")
        for name, agg in stages.items():
            lines.append(
                f'nomad_tpu_trace_span_count{{{_lbl(span=name)}}} '
                f"{agg['count']}")

    prof = profiler.summary()
    lines.append("# TYPE nomad_tpu_kernel_stage_seconds_total counter")
    for stage, secs in sorted(prof["StageSeconds"].items()):
        lines.append(
            f'nomad_tpu_kernel_stage_seconds_total{{{_lbl(stage=stage)}}} '
            f"{secs}")
    # transfer BYTES per direction: seconds say how long the
    # PCIe stages took, bytes say whether the payload shrank — the
    # device-resident cluster state's success metric
    lines.append("# TYPE nomad_tpu_kernel_transfer_bytes_total counter")
    for direction, n in sorted(prof.get("TransferBytes", {}).items()):
        lines.append(
            f'nomad_tpu_kernel_transfer_bytes_total'
            f'{{{_lbl(direction=direction)}}} {n}')
    # per-wave device-dispatch counts: program executions
    # plus the composite's eager result fetch ("wave_fetch") and the
    # deferred top-k drain ("topk_drain") — a fused steady wave is
    # exactly ONE dispatch, which TRACE_DECOMP's dispatches_per_wave
    # key gates
    if prof.get("Dispatches"):
        lines.append("# TYPE nomad_tpu_kernel_dispatches_total counter")
        for program, n in sorted(prof["Dispatches"].items()):
            lines.append(
                f'nomad_tpu_kernel_dispatches_total'
                f'{{{_lbl(program=program)}}} {n}')
    if prof["PerKey"]:
        lines.append(
            "# TYPE nomad_tpu_kernel_jit_cache_misses_total counter")
        lines.append("# TYPE nomad_tpu_kernel_launches_total counter")
        for row in prof["PerKey"]:
            labels = _lbl(kernel=row["Kernel"], key=row["Key"])
            lines.append(
                f"nomad_tpu_kernel_jit_cache_misses_total{{{labels}}} "
                f"{row['Misses']}")
            lines.append(
                f"nomad_tpu_kernel_launches_total{{{labels}}} "
                f"{row['Launches']}")
    # wave-shape series (parallel/coalesce.wave_stats): fill ratio says
    # whether the adaptive coalescer fires full or starved waves; park
    # latency percentiles are the rendezvous cost its deadline bounds
    from nomad_tpu_torch.parallel.coalesce import wave_stats

    w = wave_stats.snapshot()
    lines.append("# TYPE nomad_tpu_wave_fill_ratio gauge")
    lines.append(f"nomad_tpu_wave_fill_ratio {w['fill_ratio']:.4f}")
    lines.append("# TYPE nomad_tpu_wave_park_latency_seconds gauge")
    lines.append(
        'nomad_tpu_wave_park_latency_seconds{quantile="0.5"} '
        f"{w['park_latency_p50_ms'] / 1e3:.6f}")
    lines.append(
        'nomad_tpu_wave_park_latency_seconds{quantile="0.99"} '
        f"{w['park_latency_p99_ms'] / 1e3:.6f}")
    lines.append("# TYPE nomad_tpu_wave_launches_total counter")
    lines.append(
        'nomad_tpu_wave_launches_total{fired="full"} '
        f"{w['full_launches']}")
    lines.append(
        'nomad_tpu_wave_launches_total{fired="deadline"} '
        f"{w['deadline_launches']}")
    # sharded dispatch: waves whose node axis was split over a device
    # mesh vs mesh-present one-device fallbacks (a node axis the device
    # count does not divide): fallbacks must sit at 0 on a healthy mesh
    # server, and the mesh-device gauge says how wide the mesh is
    from nomad_tpu_torch.parallel.coalesce import sharded_wave_stats

    sh = sharded_wave_stats.snapshot()
    lines.append(
        "# TYPE nomad_tpu_wave_sharded_launches_total counter")
    lines.append(
        f"nomad_tpu_wave_sharded_launches_total {sh['launches']}")
    lines.append(
        "# TYPE nomad_tpu_wave_sharded_fallbacks_total counter")
    lines.append(
        f"nomad_tpu_wave_sharded_fallbacks_total {sh['fallbacks']}")
    lines.append(
        "# TYPE nomad_tpu_wave_sharded_mesh_devices gauge")
    lines.append(
        f"nomad_tpu_wave_sharded_mesh_devices {sh['mesh_devices']}")
    # fused dispatch: waves that ran the one-dispatch
    # mega-kernel vs fusion-wanted composite fallbacks (an
    # unsupported feature union) — fallbacks must sit at 0 on steady
    # traffic
    from nomad_tpu_torch.parallel.coalesce import fused_wave_stats

    fu = fused_wave_stats.snapshot()
    lines.append(
        "# TYPE nomad_tpu_wave_fused_launches_total counter")
    lines.append(
        f"nomad_tpu_wave_fused_launches_total {fu['launches']}")
    lines.append(
        "# TYPE nomad_tpu_wave_fused_fallbacks_total counter")
    lines.append(
        f"nomad_tpu_wave_fused_fallbacks_total {fu['fallbacks']}")
    # a fused launch that raised fails its wave's evals (no composite
    # fallback); each such wave counts here
    lines.append(
        "# TYPE nomad_tpu_wave_fused_failures_total counter")
    lines.append(
        f"nomad_tpu_wave_fused_failures_total {fu['failures']}")
    # device-resident cluster state (tensors/device_state.py): how the
    # shared wave planes advanced — row-scatter deltas vs full uploads,
    # and the dirty-row upload ratio (delta bytes / full-re-upload
    # bytes; low = the h2d tax is gone)
    from nomad_tpu_torch.tensors.device_state import default_device_state

    d = default_device_state.snapshot()
    lines.append(
        "# TYPE nomad_tpu_device_state_advances_total counter")
    for kind, key in (("hit", "hits"),
                      ("delta", "delta_advances"),
                      ("fork_delta", "fork_deltas"),
                      ("full", "full_uploads"),
                      ("usage_full", "usage_full_uploads")):
        lines.append(
            f'nomad_tpu_device_state_advances_total'
            f'{{kind="{kind}"}} {d[key]}')
    lines.append(
        "# TYPE nomad_tpu_device_state_rows_uploaded_total counter")
    lines.append(
        f"nomad_tpu_device_state_rows_uploaded_total "
        f"{d['rows_uploaded']}")
    lines.append(
        "# TYPE nomad_tpu_device_state_upload_bytes_total counter")
    lines.append(
        f"nomad_tpu_device_state_upload_bytes_total "
        f"{d['bytes_uploaded']}")
    lines.append(
        "# TYPE nomad_tpu_device_state_dirty_row_upload_ratio gauge")
    lines.append(
        f"nomad_tpu_device_state_dirty_row_upload_ratio "
        f"{d['dirty_row_upload_ratio']}")
    lines.append(
        "# TYPE nomad_tpu_device_state_resident_generations gauge")
    lines.append(
        f"nomad_tpu_device_state_resident_generations "
        f"{d['resident_generations']}")
    # advances that failed (counted, never raised: the wave then
    # uploads its planes whole)
    lines.append("# TYPE nomad_tpu_device_state_errors_total counter")
    lines.append(f"nomad_tpu_device_state_errors_total {d['errors']}")
    # feasibility compiler (nomad_tpu_torch/feasibility/): mask-program cache
    # effectiveness — a steady cluster should sit near hit_ratio 1.0,
    # with misses only on node-structure forks and novel job specs
    from nomad_tpu_torch.feasibility import default_mask_cache

    f = default_mask_cache.snapshot()
    lines.append(
        "# TYPE nomad_tpu_feasibility_mask_lookups_total counter")
    for kind, key in (("hit", "hits"), ("miss", "misses"),
                      ("fallback", "fallbacks")):
        lines.append(
            f'nomad_tpu_feasibility_mask_lookups_total'
            f'{{kind="{kind}"}} {f[key]}')
    lines.append(
        "# TYPE nomad_tpu_feasibility_program_compiles_total counter")
    lines.append(
        f"nomad_tpu_feasibility_program_compiles_total "
        f"{f['program_compiles']}")
    lines.append(
        "# TYPE nomad_tpu_feasibility_dynamic_applies_total counter")
    lines.append(
        f"nomad_tpu_feasibility_dynamic_applies_total "
        f"{f['dynamic_applies']}")
    lines.append(
        "# TYPE nomad_tpu_feasibility_mask_hit_ratio gauge")
    lines.append(
        f"nomad_tpu_feasibility_mask_hit_ratio {f['hit_ratio']}")
    lines.append(
        "# TYPE nomad_tpu_feasibility_cached_masks gauge")
    lines.append(
        f"nomad_tpu_feasibility_cached_masks {f['cached_masks']}")
    # plan group commit (server/plan_apply.py): wave-window plan
    # re-validation — vector-proven vs exact-walk fallback plans,
    # rejected node plans, and the batched raft entries' plan counts
    # and payload bytes. fallback > 0 on a lean burst is a regression
    # (the steady-state gate requires 0).
    from nomad_tpu_torch.server.plan_apply import plan_group_stats

    g = plan_group_stats.snapshot()
    lines.append("# TYPE nomad_tpu_plan_group_plans_total counter")
    for kind, key in (("vector", "vector_plans"),
                      ("fallback", "fallback_plans")):
        lines.append(
            f'nomad_tpu_plan_group_plans_total{{kind="{kind}"}} '
            f'{g[key]}')
    lines.append(
        "# TYPE nomad_tpu_plan_group_port_plans_total counter")
    for kind, key in (("vector", "port_vector_plans"),
                      ("fallback", "port_fallback_plans")):
        lines.append(
            f'nomad_tpu_plan_group_port_plans_total{{kind="{kind}"}} '
            f'{g[key]}')
    lines.append("# TYPE nomad_tpu_plan_group_rejects_total counter")
    lines.append(
        f"nomad_tpu_plan_group_rejects_total "
        f"{g['rejected_node_plans']}")
    lines.append("# TYPE nomad_tpu_plan_group_commits_total counter")
    lines.append(
        f"nomad_tpu_plan_group_commits_total {g['commit_batches']}")
    lines.append(
        "# TYPE nomad_tpu_plan_group_committed_plans_total counter")
    lines.append(
        f"nomad_tpu_plan_group_committed_plans_total "
        f"{g['committed_plans']}")
    lines.append("# TYPE nomad_tpu_plan_group_bytes_total counter")
    lines.append(
        f"nomad_tpu_plan_group_bytes_total {g['batch_bytes']}")
    lines.append("# TYPE nomad_tpu_plan_group_size_avg gauge")
    lines.append(
        f"nomad_tpu_plan_group_size_avg "
        f"{round(g['group_size_avg'], 4)}")
    # plan rejection tracker (server/plan_rejection.py; Nomad 1.3's
    # plan_rejection_tracker): per-node applier-rejection pressure and
    # the eligibility flips it drove — a node "eating the cluster"
    # shows up here before it shows up as a throughput mystery
    from nomad_tpu_torch.server.plan_rejection import plan_rejections

    pr = plan_rejections.snapshot()
    lines.append(
        "# TYPE nomad_tpu_plan_rejection_node_rejections_total "
        "counter")
    lines.append(
        f"nomad_tpu_plan_rejection_node_rejections_total "
        f"{pr['rejections']}")
    lines.append(
        "# TYPE nomad_tpu_plan_rejection_marked_ineligible_total "
        "counter")
    lines.append(
        f"nomad_tpu_plan_rejection_marked_ineligible_total "
        f"{pr['nodes_marked']}")
    lines.append(
        "# TYPE nomad_tpu_plan_rejection_tracked_nodes gauge")
    lines.append(
        f"nomad_tpu_plan_rejection_tracked_nodes "
        f"{pr['tracked_nodes']}")
    # fault-injection plane (utils/faultpoints.py): per-point
    # hit/fire counters plus the armed gauge. Disarmed processes show
    # armed=0 and no per-point series — exactly the no-op promise.
    from nomad_tpu_torch.utils import faultpoints

    fp = faultpoints.stats()
    lines.append("# TYPE nomad_tpu_fault_armed gauge")
    lines.append(
        f"nomad_tpu_fault_armed {1 if faultpoints.armed() else 0}")
    if fp:
        lines.append("# TYPE nomad_tpu_fault_hits_total counter")
        for point, row in fp.items():
            lines.append(
                f'nomad_tpu_fault_hits_total'
                f'{{{_lbl(point=point)}}} {row["hits"]}')
        lines.append("# TYPE nomad_tpu_fault_fires_total counter")
        for point, row in fp.items():
            kind = row["kind"] or "none"
            lines.append(
                f'nomad_tpu_fault_fires_total'
                f'{{{_lbl(point=point, kind=kind)}}} '
                f'{row["fires"]}')
    # raft durability plane (raft/wal.py): WAL frame/fsync
    # volume, recovery accounting (replayed entries, torn-tail
    # truncations), and the snapshot byte meters (in-memory cache vs
    # on-disk files). In-memory raft shows zeros — the disarmed-cost
    # promise, like the fault plane's.
    from nomad_tpu_torch.raft.wal import wal_stats

    d = wal_stats.snapshot()
    lines.append(
        "# TYPE nomad_tpu_raft_durability_fsyncs_total counter")
    lines.append(
        f"nomad_tpu_raft_durability_fsyncs_total {d['fsyncs']}")
    lines.append(
        "# TYPE nomad_tpu_raft_durability_frames_total counter")
    lines.append(
        f"nomad_tpu_raft_durability_frames_total {d['frames']}")
    lines.append(
        "# TYPE nomad_tpu_raft_durability_bytes_total counter")
    lines.append(
        f"nomad_tpu_raft_durability_bytes_total {d['bytes_written']}")
    lines.append(
        "# TYPE nomad_tpu_raft_durability_replayed_entries_total "
        "counter")
    lines.append(
        f"nomad_tpu_raft_durability_replayed_entries_total "
        f"{d['replayed_entries']}")
    lines.append(
        "# TYPE nomad_tpu_raft_durability_torn_truncations_total "
        "counter")
    lines.append(
        f"nomad_tpu_raft_durability_torn_truncations_total "
        f"{d['torn_truncations']}")
    lines.append(
        "# TYPE nomad_tpu_raft_durability_recoveries_total counter")
    lines.append(
        f"nomad_tpu_raft_durability_recoveries_total "
        f"{d['recoveries']}")
    lines.append("# TYPE nomad_tpu_raft_snapshots_total counter")
    for kind, key in (("written", "snapshots_written"),
                      ("pruned", "snapshots_pruned"),
                      ("invalid", "snapshots_invalid")):
        lines.append(
            f'nomad_tpu_raft_snapshots_total{{kind="{kind}"}} '
            f'{d[key]}')
    lines.append("# TYPE nomad_tpu_raft_snapshot_bytes gauge")
    for kind, key in (("cache", "snapshot_cache_bytes"),
                      ("disk", "snapshot_disk_bytes")):
        lines.append(
            f'nomad_tpu_raft_snapshot_bytes{{kind="{kind}"}} '
            f'{d[key]}')
    # per-replica consensus plane: raft state/term/lag and
    # WAL counters with a server_id label, so co-resident
    # make_cluster servers report three distinguishable truths
    # instead of one blended process-global one. Aggregate series
    # above stay for single-server scrapes; these are the per-replica
    # view the cluster-health endpoint renders.
    from nomad_tpu_torch.raft.observe import raft_observer
    from nomad_tpu_torch.raft.wal import wal_stats as _wal_stats

    per = raft_observer.snapshot()
    live = {sid: row for sid, row in sorted(per.items())
            if row.get("live")}
    if live:
        for series, key in (("nomad_tpu_raft_term", "term"),
                            ("nomad_tpu_raft_is_leader",
                             "is_leader"),
                            ("nomad_tpu_raft_commit_index",
                             "commit_index"),
                            ("nomad_tpu_raft_last_applied",
                             "last_applied")):
            lines.append(f"# TYPE {series} gauge")
            for sid, row in live.items():
                lines.append(
                    f'{series}{{{_lbl(server_id=sid)}}} {row[key]}')
        lines.append(
            "# TYPE nomad_tpu_raft_peer_lag_entries gauge")
        lines.append(
            "# TYPE nomad_tpu_raft_peer_last_contact_seconds gauge")
        for sid, row in live.items():
            for peer, lag in sorted(
                    row.get("peer_lag_entries", {}).items()):
                lines.append(
                    f'nomad_tpu_raft_peer_lag_entries'
                    f'{{{_lbl(server_id=sid, peer=peer)}}} {lag}')
            for peer, age in sorted(
                    row.get("peer_last_contact_s", {}).items()):
                lines.append(
                    f'nomad_tpu_raft_peer_last_contact_seconds'
                    f'{{{_lbl(server_id=sid, peer=peer)}}} {age}')
        # replication pipeline + leader lease: window
        # occupancy per peer, arm/drain counters, and the lease
        # fast-path/barrier read split
        for series, key, mtype in (
                ("nomad_tpu_raft_pipeline_armed_peers",
                 "pipeline_armed", "gauge"),
                ("nomad_tpu_raft_pipeline_batches_total",
                 "pipeline_batches", "counter"),
                ("nomad_tpu_raft_pipeline_drains_total",
                 "pipeline_drains", "counter"),
                ("nomad_tpu_raft_lease_valid", "lease_valid",
                 "gauge"),
                ("nomad_tpu_raft_lease_age_seconds", "lease_age_s",
                 "gauge")):
            lines.append(f"# TYPE {series} {mtype}")
            for sid, row in live.items():
                val = row.get(key)
                if val is None:
                    continue
                lines.append(
                    f'{series}{{{_lbl(server_id=sid)}}} {val}')
        lines.append(
            "# TYPE nomad_tpu_raft_pipeline_inflight_batches gauge")
        lines.append(
            "# TYPE nomad_tpu_raft_lease_reads_total counter")
        for sid, row in live.items():
            for peer, n in sorted(
                    (row.get("pipeline_inflight") or {}).items()):
                lines.append(
                    f'nomad_tpu_raft_pipeline_inflight_batches'
                    f'{{{_lbl(server_id=sid, peer=peer)}}} {n}')
            for path, key in (("fast", "lease_reads_fast"),
                              ("barrier", "lease_reads_barrier")):
                val = row.get(key)
                if val is None:
                    continue
                lines.append(
                    f'nomad_tpu_raft_lease_reads_total'
                    f'{{{_lbl(server_id=sid, path=path)}}} {val}')
    if any(row.get("transitions") or row.get("replicated_entries")
           or row.get("snapshot_xfer_bytes")
           for row in per.values()):
        lines.append(
            "# TYPE nomad_tpu_raft_transitions_total counter")
        lines.append(
            "# TYPE nomad_tpu_raft_replicated_entries_total counter")
        lines.append("# TYPE nomad_tpu_raft_peer_lag_seconds gauge")
        lines.append(
            "# TYPE nomad_tpu_raft_snapshot_transfer_bytes_total "
            "counter")
        for sid, row in sorted(per.items()):
            for kind, n in sorted(row["transitions"].items()):
                lines.append(
                    f'nomad_tpu_raft_transitions_total'
                    f'{{{_lbl(server_id=sid, kind=kind)}}} {n}')
            for peer, n in sorted(
                    row["replicated_entries"].items()):
                lines.append(
                    f'nomad_tpu_raft_replicated_entries_total'
                    f'{{{_lbl(server_id=sid, peer=peer)}}} {n}')
            for peer, ms in sorted(row["peer_lag_ms"].items()):
                lines.append(
                    f'nomad_tpu_raft_peer_lag_seconds'
                    f'{{{_lbl(server_id=sid, peer=peer)}}} '
                    f'{ms / 1e3:.6f}')
            for direction, n in sorted(
                    row["snapshot_xfer_bytes"].items()):
                lines.append(
                    f'nomad_tpu_raft_snapshot_transfer_bytes_total'
                    f'{{{_lbl(server_id=sid, direction=direction)}}} '
                    f'{n}')
    walper = _wal_stats.per_server()
    if walper:
        for series, key, mtype in (
                ("nomad_tpu_raft_wal_frames_total", "frames",
                 "counter"),
                ("nomad_tpu_raft_wal_fsyncs_total", "fsyncs",
                 "counter"),
                ("nomad_tpu_raft_wal_bytes_total", "bytes_written",
                 "counter"),
                ("nomad_tpu_raft_wal_replayed_entries_total",
                 "replayed_entries", "counter"),
                ("nomad_tpu_raft_wal_torn_truncations_total",
                 "torn_truncations", "counter"),
                ("nomad_tpu_raft_wal_segments", "segments",
                 "gauge"),
                ("nomad_tpu_raft_wal_pending_frames",
                 "pending_frames", "gauge"),
                ("nomad_tpu_raft_wal_fsync_batch_avg",
                 "fsync_batch_avg", "gauge"),
                ("nomad_tpu_raft_wal_failed", "wal_failed",
                 "gauge")):
            lines.append(f"# TYPE {series} {mtype}")
            for sid, row in sorted(walper.items()):
                lines.append(
                    f'{series}{{{_lbl(server_id=sid)}}} '
                    f'{row.get(key, 0)}')
    # wave-cohort drain accounting (utils/wavecohort.py): the plan
    # queue's wave-boundary batching — armed waves, landed plans,
    # whole-cohort drains vs expirations vs hard-cap clamps, and the
    # learned drain-window EWMA
    from nomad_tpu_torch.utils.wavecohort import wave_cohorts

    c = wave_cohorts.snapshot()
    lines.append("# TYPE nomad_tpu_wave_cohort_waves_total counter")
    lines.append(f"nomad_tpu_wave_cohort_waves_total {c['waves']}")
    lines.append("# TYPE nomad_tpu_wave_cohort_plans_total counter")
    lines.append(
        f"nomad_tpu_wave_cohort_plans_total {c['cohort_plans']}")
    lines.append(
        "# TYPE nomad_tpu_wave_cohort_outcomes_total counter")
    for kind, key in (("drained", "drained_cohorts"),
                      ("expired", "expired_cohorts"),
                      ("hard_cap", "hard_cap_hits")):
        lines.append(
            f'nomad_tpu_wave_cohort_outcomes_total'
            f'{{kind="{kind}"}} {c[key]}')
    lines.append(
        "# TYPE nomad_tpu_wave_cohort_drain_ewma_seconds gauge")
    lines.append(
        f"nomad_tpu_wave_cohort_drain_ewma_seconds "
        f"{c['drain_ewma_ms'] / 1e3:.6f}")
    # blocking-query wakeups (state/store.py watch_stats): the watch
    # side of the serving plane — parked watchers, real vs spurious
    # wakeups, expired waits
    from nomad_tpu_torch.state.store import watch_stats

    w = watch_stats.snapshot()
    lines.append("# TYPE nomad_tpu_watch_held_watchers gauge")
    lines.append(
        f"nomad_tpu_watch_held_watchers {w['held_watchers']}")
    lines.append("# TYPE nomad_tpu_watch_wakeups_total counter")
    for kind, key in (("real", "wakeups"),
                      ("spurious", "spurious_wakeups"),
                      ("timeout", "timeouts")):
        lines.append(
            f'nomad_tpu_watch_wakeups_total{{kind="{kind}"}} '
            f'{w[key]}')
    # MVCC store plane (state/store.py store_stats): write-transaction
    # and snapshot volume, the last committed generation, and how many
    # generation roots are still alive (pinned by snapshots or the
    # registry) — the retention gauge that catches a generation leak
    from nomad_tpu_torch.state.store import store_stats

    st = store_stats.snapshot()
    lines.append("# TYPE nomad_tpu_store_write_txns_total counter")
    lines.append(
        f"nomad_tpu_store_write_txns_total {st['write_txns']}")
    lines.append("# TYPE nomad_tpu_store_snapshots_total counter")
    lines.append(
        f"nomad_tpu_store_snapshots_total {st['snapshots']}")
    lines.append("# TYPE nomad_tpu_store_restores_total counter")
    lines.append(
        f"nomad_tpu_store_restores_total {st['restores']}")
    lines.append("# TYPE nomad_tpu_store_generation gauge")
    lines.append(
        f"nomad_tpu_store_generation {st['last_generation']}")
    lines.append("# TYPE nomad_tpu_store_live_roots gauge")
    lines.append(
        f"nomad_tpu_store_live_roots {st['live_roots']}")
    # retention split: roots held by in-process snapshot
    # refs vs pinned by worker-process generation leases — a stuck
    # lease shows up as `holder="leased"` climbing while
    # `holder="in_process"` stays flat
    for holder, key in (("in_process", "live_roots_in_process"),
                        ("leased", "live_roots_leased")):
        lines.append(
            f'nomad_tpu_store_live_roots{{holder="{holder}"}} '
            f'{st[key]}')
    # heartbeat fan-in (server/server.py client_update_stats): raw
    # heartbeat rate plus the Node.UpdateAlloc group-commit's
    # coalescing (callers vs batched raft entries)
    from nomad_tpu_torch.server.server import client_update_stats

    u = client_update_stats.snapshot()
    lines.append("# TYPE nomad_tpu_heartbeats_total counter")
    lines.append(f"nomad_tpu_heartbeats_total {u['heartbeats']}")
    lines.append(
        "# TYPE nomad_tpu_client_update_fanin_total counter")
    for kind, key in (("callers", "callers"),
                      ("batches", "batches"),
                      ("allocs", "allocs")):
        lines.append(
            f'nomad_tpu_client_update_fanin_total'
            f'{{kind="{kind}"}} {u[key]}')
    # read plane (server/readplane.py): who served reads
    # (role), per-mode volume, follower fence forwards + retries +
    # failures, linearizable lease->barrier demotions, and max_stale
    # rejections. The staleness distribution itself rides the shared
    # histogram registry (op="read_staleness" below).
    from nomad_tpu_torch.server.readplane import read_stats

    r = read_stats.snapshot()
    lines.append("# TYPE nomad_tpu_read_served_total counter")
    for role, n in sorted(r["served"].items()):
        lines.append(
            f'nomad_tpu_read_served_total{{role="{role}"}} {n}')
    lines.append("# TYPE nomad_tpu_read_requests_total counter")
    for mode, n in sorted(r["modes"].items()):
        lines.append(
            f'nomad_tpu_read_requests_total{{mode="{mode}"}} {n}')
    lines.append("# TYPE nomad_tpu_read_forwards_total counter")
    lines.append(f"nomad_tpu_read_forwards_total {r['forwards']}")
    lines.append(
        "# TYPE nomad_tpu_read_forward_retries_total counter")
    lines.append(
        f"nomad_tpu_read_forward_retries_total "
        f"{r['forward_retries']}")
    lines.append(
        "# TYPE nomad_tpu_read_forward_failures_total counter")
    lines.append(
        f"nomad_tpu_read_forward_failures_total "
        f"{r['forward_failures']}")
    lines.append("# TYPE nomad_tpu_read_demotions_total counter")
    lines.append(f"nomad_tpu_read_demotions_total {r['demotions']}")
    lines.append(
        "# TYPE nomad_tpu_read_lease_fast_total counter")
    lines.append(
        f"nomad_tpu_read_lease_fast_total {r['lease_fast']}")
    lines.append(
        "# TYPE nomad_tpu_read_stale_rejects_total counter")
    lines.append(
        f"nomad_tpu_read_stale_rejects_total {r['stale_rejects']}")
    # event-stream ring health (server/stream.py): publish/deliver
    # volume, slow-consumer losses, the widest subscriber lag, and the
    # wire bytes the NDJSON endpoint shipped — per-broker state, so
    # only present when the HTTP layer passes its server's broker
    if event_broker is not None:
        s = event_broker.snapshot()
        lines.append("# TYPE nomad_tpu_stream_subscribers gauge")
        lines.append(f"nomad_tpu_stream_subscribers {s['subscribers']}")
        lines.append("# TYPE nomad_tpu_stream_events_total counter")
        for kind, key in (("published", "published_events"),
                          ("delivered", "delivered_events"),
                          ("lost", "lost_events")):
            lines.append(
                f'nomad_tpu_stream_events_total{{kind="{kind}"}} '
                f'{s[key]}')
        lines.append("# TYPE nomad_tpu_stream_delivered_bytes_total counter")
        lines.append(
            f"nomad_tpu_stream_delivered_bytes_total "
            f"{s['delivered_bytes']}")
        lines.append("# TYPE nomad_tpu_stream_max_lag_events gauge")
        lines.append(
            f"nomad_tpu_stream_max_lag_events {s['max_lag_events']}")
        lines.append("# TYPE nomad_tpu_stream_retained_events gauge")
        lines.append(
            f"nomad_tpu_stream_retained_events {s['retained_events']}")
    # streaming latency histograms (telemetry/histogram.py): the real
    # Prometheus histogram type — log-bucketed cumulative _bucket
    # series per op (e2e eval latency, plan queue/evaluate/commit,
    # wave park, snapshot wait), the distribution substrate behind the
    # TRACE_DECOMP tail table and the flight recorder's threshold
    hist_items = [(name, h) for name, h in histograms.items()
                  if h.count > 0]
    if hist_items:
        lines.append("# TYPE nomad_tpu_latency_seconds histogram")
        for name, h in hist_items:
            lines.extend(h.prometheus_lines(
                "nomad_tpu_latency_seconds", _lbl(op=name)))
    # slow-eval flight recorder health: captures say the tail is being
    # recorded, threshold says where the adaptive p99 bar sits
    fr = flight_recorder.snapshot()
    lines.append(
        "# TYPE nomad_tpu_slow_evals_captured_total counter")
    lines.append(
        f"nomad_tpu_slow_evals_captured_total {fr['captured']}")
    lines.append("# TYPE nomad_tpu_slow_eval_threshold_seconds gauge")
    lines.append(
        f"nomad_tpu_slow_eval_threshold_seconds "
        f"{fr['threshold_ms'] / 1e3:.6f}")
    # consensus flight recorder health: slow raft appends /
    # fsync batches / elections captured past the adaptive bar
    cr = consensus_recorder.snapshot()
    lines.append("# TYPE nomad_tpu_slow_raft_captured_total counter")
    lines.append(
        f"nomad_tpu_slow_raft_captured_total {cr['captured']}")
    lines.append(
        "# TYPE nomad_tpu_telemetry_enabled gauge")
    lines.append(
        f"nomad_tpu_telemetry_enabled {1 if tracer.enabled else 0}")
    return "\n".join(lines) + "\n"


def traces_json(limit: int = 2000, trace_id: str = "") -> Dict:
    """The /v1/operator/traces body. ``trace_id`` narrows the span dump
    to one eval's tree (the ``?trace_id=`` query param — the operator's
    "show me THIS slow eval" handle; aggregates stay global)."""
    spans = tracer.spans(trace_id=trace_id or None)
    if limit and len(spans) > limit:
        spans = spans[-limit:]
    return {
        "Enabled": tracer.enabled,
        "TraceID": trace_id,
        "Spans": [s.to_api() for s in spans],
        "Stages": {
            name: {
                "Count": agg["count"],
                "TotalMs": round(agg["total_s"] * 1e3, 4),
                "ExclusiveMs": round(agg["exclusive_s"] * 1e3, 4),
            }
            for name, agg in tracer.stage_totals().items()
        },
        "Kernel": profiler.summary(),
    }


def stream_health_json(event_broker) -> Dict:
    """The /v1/operator/stream-health body: the serving plane's state
    in one pull — event-ring health, blocking-query wakeup accounting,
    heartbeat fan-in coalescing, and the delivery-lag distribution
    (the same ``stream_deliver`` series /v1/metrics exposes)."""
    from nomad_tpu_torch.server.server import client_update_stats
    from nomad_tpu_torch.state.store import watch_stats
    from nomad_tpu_torch.telemetry.histogram import STREAM_DELIVER

    deliver = histograms.peek(STREAM_DELIVER)
    return {
        "Stream": event_broker.snapshot() if event_broker is not None
        else {},
        "Watch": watch_stats.snapshot(),
        "Heartbeat": client_update_stats.snapshot(),
        "DeliverLatency": deliver.snapshot() if deliver is not None
        else {},
    }


def cluster_health_json(server) -> Dict:
    """The ``GET /v1/operator/cluster-health`` body: the
    autopilot-style per-peer consensus picture from THIS server's
    vantage — raft identity/term/state + per-peer match/lag/contact
    (leader-side), its WAL occupancy + durability counters, the
    consensus latency distributions, election/term transition
    counters, the fault plane's arm state, and the consensus flight
    recorder's health."""
    from nomad_tpu_torch.raft.observe import raft_observer
    from nomad_tpu_torch.raft.wal import wal_stats
    from nomad_tpu_torch.telemetry.histogram import (
        RAFT_APPEND,
        RAFT_ELECTION,
        RAFT_QUORUM,
        RAFT_REPLICATION,
        WAL_FSYNC,
    )
    from nomad_tpu_torch.utils import faultpoints

    raft = server.raft
    if raft is not None:
        body = raft.cluster_health()
    else:
        body = {
            "ServerId": server.config.name,
            "State": "leader" if server.is_leader() else "follower",
            "Term": 0,
            "Leader": server.config.name if server.is_leader() else None,
            "CommitIndex": server.state.latest_index(),
            "LastApplied": server.state.latest_index(),
            "LastLogIndex": server.state.latest_index(),
            "Peers": [],
        }
    sid = body["ServerId"]
    obs = raft_observer.snapshot().get(sid, {})
    body["Transitions"] = obs.get("transitions", {})
    body["ReplicatedEntries"] = obs.get("replicated_entries", {})
    body["PeerLagMs"] = obs.get("peer_lag_ms", {})
    body["SnapshotTransferBytes"] = obs.get("snapshot_xfer_bytes", {})
    body["Wal"] = wal_stats.per_server().get(sid, {})
    body["Faults"] = {
        "Armed": faultpoints.armed(),
        "Points": faultpoints.stats(),
    }
    lat = {}
    for op in (RAFT_REPLICATION, RAFT_QUORUM, RAFT_APPEND,
               RAFT_ELECTION, WAL_FSYNC):
        h = histograms.peek(op)
        if h is not None and h.count > 0:
            lat[op] = h.snapshot()
    body["Latency"] = lat
    body["SlowRaft"] = consensus_recorder.snapshot()
    return body


def slow_raft_json(limit: int = 0) -> Dict:
    """The ``GET /v1/operator/slow-raft`` body: the consensus flight
    recorder's captured slow-op records (appends, fsync batches,
    elections past their adaptive thresholds), newest last, plus its
    health counters — the eval recorder's sibling."""
    cr = consensus_recorder.snapshot()
    trees = consensus_recorder.trees()
    if limit and len(trees) > limit:
        trees = trees[-limit:]
    return {
        "Enabled": tracer.enabled,
        "Captured": cr["captured"],
        "Retained": cr["retained"],
        "ThresholdsMs": cr["thresholds_ms"],
        "Observed": cr["observed"],
        "Trees": trees,
    }


def slow_evals_json(limit: int = 0) -> Dict:
    """The /v1/operator/slow-evals body: the flight recorder's ring of
    captured slow-eval span trees, newest last, plus its health
    counters and the adaptive threshold."""
    fr = flight_recorder.snapshot()
    trees = flight_recorder.trees()
    if limit and len(trees) > limit:
        trees = trees[-limit:]
    return {
        "Enabled": tracer.enabled,
        "Observed": fr["observed"],
        "Captured": fr["captured"],
        "Retained": fr["retained"],
        "ThresholdMs": fr["threshold_ms"],
        "Histogram": {
            name: h.snapshot()
            for name, h in histograms.items() if h.count > 0
        },
        "Trees": trees,
    }
