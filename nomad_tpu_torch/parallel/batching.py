"""Eval batching: many evaluations against one snapshot, one launch per batch.

Counterpart of ``nomad_tpu/parallel/batching.py``, the throughput path:
B evals are scheduled against the same cluster snapshot (optimistic
concurrency, like reference workers on a shared snapshot,
nomad/worker.go:537) and every accepted placement is committed to the
device-resident utilization planes as a scatter-add (the plan applier's
state update, nomad/plan_apply.go:209).

How the JAX constructs become torch:

- ``lax.scan`` over batches is a Python loop (``_scan_with_reset``); the
  loops return what JAX's return.
- ``vmap`` over evals is the leading eval axis of ``ops/kernel``'s
  ``place_taskgroup``/``place_taskgroup_topk`` (lean envelope, devices
  and top-k; other feature sets raise ``ValueError``).
- ``_jit_donating`` becomes a rule: nothing here writes into a caller's
  tensor. Every carry update is a new tensor (``index_add`` out of place),
  so the caller's planes survive every call.
- ``_bound_fallback``'s batch-level ``lax.cond`` becomes a re-run of the
  full-width ``place_taskgroup`` for the breached evals only. Evals of a
  batch are independent of each other, so their results are the ones the
  whole-batch re-run would give; the check reads ``valid`` back once per
  batch.
"""

from __future__ import annotations

import numpy as np
import torch

from nomad_tpu_torch.device import DeviceLike, resolve_device
from nomad_tpu_torch.ops.cuda_kernel import place_batch, topk_place_batch
from nomad_tpu_torch.ops.kernel import (
    FULL_FEATURES,
    LEAN_FEATURES,
    MAX_DEV_REQS,
    NEG_INF,
    KernelFeatures,
    KernelIn,
    _argmax_first,
    _rows,
    place_taskgroup,
    place_taskgroup_topk,
)

BACKENDS = ("torch", "kernel_topk")


def device_put_shared(kin: KernelIn, device: DeviceLike = None) -> KernelIn:
    """Stage the shared planes on ``device`` once (the card unless
    ``device="cpu"``); numpy leaves are copied, tensors moved."""
    dev = resolve_device(device)
    return KernelIn(*[
        (x if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.array(x))).to(dev) for x in kin])


def commit_placements(used_cpu, used_mem, chosen, found, ask_cpu, ask_mem):
    """Scatter every accepted placement's ask into the utilization planes
    (batching.py:505-519). ``chosen`` i32[B,K] node rows, ``found``
    bool[B,K]. Returns new planes; the given ones are not written."""
    rows = chosen.reshape(-1).to(torch.int64)
    ok = found.reshape(-1)
    safe = torch.where(ok, rows, 0)

    def add(plane, ask):
        w = ask[:, None].expand(chosen.shape).reshape(-1)
        return plane.index_add(0, safe, torch.where(ok, w, 0.0))

    return add(used_cpu, ask_cpu), add(used_mem, ask_mem)


def _bound_fallback(valid, primary: tuple, full_rows) -> tuple:
    """Candidate-set bound contract (batching.py:64-78): evals whose bound
    broke take the full-width results. ``primary`` is a tuple of [B, ...]
    tensors; ``full_rows(rows)`` computes the same tuple for the evals
    ``rows`` only. One readback of ``valid`` per batch."""
    bad = torch.nonzero(~valid).flatten()
    if bad.numel() == 0:
        return primary
    full = full_rows(bad)
    return tuple(p.index_copy(0, bad, f) for p, f in zip(primary, full))


def _lean_args(shared: KernelIn, uc, um, ask_cpu, ask_mem, n_steps):
    """The kernels' 16 lean arguments (``pallas_place_batch`` order)."""
    return (shared.cap_cpu, shared.cap_mem, shared.cap_disk,
            uc, um, shared.used_disk,
            shared.base_mask, shared.job_tg_count, shared.penalty,
            shared.aff_score,
            ask_cpu, ask_mem, shared.ask_disk,
            n_steps, shared.desired_count, shared.algorithm_spread)


def make_schedule_apply_step(k_steps: int,
                             features: KernelFeatures = FULL_FEATURES):
    """Batch schedule + plan apply (batching.py:81-115): returns
    ``fn(shared, used_cpu, used_mem, ask_cpu[B], ask_mem[B], n_steps[B])
    -> (KernelOut[B], used_cpu', used_mem')``."""

    def step(shared: KernelIn, used_cpu, used_mem, ask_cpu, ask_mem,
             n_steps):
        kin = shared._replace(used_cpu=used_cpu, used_mem=used_mem,
                              ask_cpu=ask_cpu, ask_mem=ask_mem,
                              n_steps=n_steps)
        out = place_taskgroup(kin, k_steps, features)
        return (out, *commit_placements(used_cpu, used_mem, out.chosen,
                                        out.found, ask_cpu, ask_mem))

    return step


def make_schedule_apply_step_kernel(k_steps: int):
    """The step above with the lean full-width kernel (B3) inside, the
    counterpart of ``make_schedule_apply_step_pallas``
    (pallas_kernel.py:499-534): ``fn(...) -> (PlaceOut, used_cpu',
    used_mem')``. Commits cpu and mem, as JAX's does."""

    def step(shared: KernelIn, used_cpu, used_mem, ask_cpu, ask_mem,
             n_steps):
        out = place_batch(*_lean_args(shared, used_cpu, used_mem, ask_cpu,
                                      ask_mem, n_steps), k_steps=k_steps)
        return (out, *commit_placements(used_cpu, used_mem, out.chosen,
                                        out.found, ask_cpu, ask_mem))

    return step


def _scan_with_reset(one_batch, planes: tuple, asks: tuple,
                     reset_every: int):
    """The multi-batch loop (batching.py:279-300): ``planes`` is the
    carried plane tuple, ``asks`` the tuple of [T, ...] inputs. With
    ``reset_every`` the initial planes come back every that many
    batches. Returns ``(planes', stats stacked over T)``."""
    init = planes
    stats = []
    for t in range(int(asks[0].shape[0])):
        if reset_every and t % reset_every == 0:
            planes = init
        planes, s = one_batch(planes, tuple(a[t] for a in asks))
        stats.append(s)
    return planes, tuple(torch.stack(s) for s in zip(*stats))


def make_schedule_apply_loop(k_steps: int,
                             features: KernelFeatures = FULL_FEATURES,
                             topk: bool = False,
                             backend: str = "torch",
                             reset_every: int = 0):
    """T batches of B evals (batching.py:118-276).

    ``backend``: ``"torch"`` runs the batched composites (full-width, or
    candidate-set when ``topk``); ``"kernel_topk"`` runs
    ``topk_place_batch``, whose K-step candidate scan is the B2 kernel on
    the card. Breached candidate bounds fall back to the full-width
    composite inside the loop, so every eval is served exactly.
    ``reset_every`` restores the initial utilization planes every that
    many batches (0 = never).

    Returns ``fn(shared, used_cpu, used_mem, ask_cpu[T,B], ask_mem[T,B],
    n_steps[B]) -> (score_sum, placed, fallback, used_cpu', used_mem')``,
    0-d tensors and [N] planes on the device of the inputs."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    if backend == "kernel_topk" and (features != LEAN_FEATURES or not topk):
        # the kernel scores the lean envelope with candidates; its
        # breached rows must fall back to the same score function
        raise ValueError("backend 'kernel_topk' takes LEAN_FEATURES with "
                         "topk=True only")

    def place(shared, uc, um, a_cpu, a_mem, n_steps):
        kin = shared._replace(used_cpu=uc, used_mem=um, ask_cpu=a_cpu,
                              ask_mem=a_mem, n_steps=n_steps)
        if backend == "kernel_topk":
            chosen, scores, found, valid = topk_place_batch(
                *_lean_args(shared, uc, um, a_cpu, a_mem, n_steps),
                k_steps=k_steps)
        elif topk:
            out, valid = place_taskgroup_topk(kin, k_steps, features)
            chosen, scores, found = out.chosen, out.scores, out.found
        else:
            out = place_taskgroup(kin, k_steps, features)
            return out.chosen, out.scores, out.found, None

        def full_rows(rows):
            o = place_taskgroup(kin._replace(
                ask_cpu=a_cpu[rows], ask_mem=a_mem[rows],
                n_steps=n_steps[rows]), k_steps, features)
            return o.chosen, o.scores, o.found

        return (*_bound_fallback(valid, (chosen, scores, found), full_rows),
                valid)

    def loop(shared: KernelIn, used_cpu, used_mem, ask_cpu, ask_mem,
             n_steps):
        def one_batch(planes, asks):
            uc, um = planes
            a_cpu, a_mem = asks
            chosen, scores, found, valid = place(shared, uc, um, a_cpu,
                                                 a_mem, n_steps)
            breached = (torch.zeros((), dtype=torch.int64,
                                    device=uc.device)
                        if valid is None else torch.sum(~valid))
            stats = (torch.sum(torch.where(found, scores, 0.0)),
                     torch.sum(found), breached)
            return commit_placements(uc, um, chosen, found, a_cpu,
                                     a_mem), stats

        (uc, um), (scores, placed, fallback) = _scan_with_reset(
            one_batch, (used_cpu, used_mem), (ask_cpu, ask_mem),
            reset_every)
        return scores.sum(), placed.sum(), fallback.sum(), uc, um

    return loop


#: the device cell's features (batching.py:320-325)
DEVICE_FEATURES = KernelFeatures(
    n_spreads=0, with_topk=False, with_devices=True, with_ports=False,
    with_cores=False, with_network=False, with_distinct=False,
    with_step_penalties=False, with_preferred=False)


def make_device_apply_loop(k_steps: int, reset_every: int = 0):
    """The GPU device-plugin cell (batching.py:303-368): the carry adds
    the per-node free-device plane, placements deduct device asks between
    steps (device.go:32) and commit them across batches.

    Returns ``fn(shared, used_cpu, used_mem, dev_free, ask_cpu[T,B],
    ask_mem[T,B], ask_gpu[T,B], n_steps[B]) -> (score_sum, placed,
    used_cpu', used_mem', dev_free')``."""

    def loop(shared: KernelIn, used_cpu, used_mem, dev_free,
             ask_cpu, ask_mem, ask_gpu, n_steps):
        def one_batch(planes, asks):
            uc, um, df = planes
            a_cpu, a_mem, a_gpu = asks
            ad = torch.zeros((a_gpu.shape[0], MAX_DEV_REQS),
                             dtype=torch.float32, device=a_gpu.device)
            ad[:, 0] = a_gpu
            out = place_taskgroup(shared._replace(
                used_cpu=uc, used_mem=um, dev_free=df, ask_cpu=a_cpu,
                ask_mem=a_mem, ask_dev=ad, n_steps=n_steps),
                k_steps, DEVICE_FEATURES)
            uc2, um2 = commit_placements(uc, um, out.chosen, out.found,
                                         a_cpu, a_mem)
            ok = out.found.reshape(-1)
            safe = torch.where(ok, out.chosen.reshape(-1).to(torch.int64), 0)
            w = a_gpu[:, None].expand(out.chosen.shape).reshape(-1)
            col = df[:, 0].index_add(0, safe, -torch.where(ok, w, 0.0))
            df2 = torch.cat([col[:, None], df[:, 1:]], dim=1)
            stats = (torch.sum(torch.where(out.found, out.scores, 0.0)),
                     torch.sum(out.found))
            return (uc2, um2, df2), stats

        (uc, um, df), (scores, placed) = _scan_with_reset(
            one_batch, (used_cpu, used_mem, dev_free),
            (ask_cpu, ask_mem, ask_gpu), reset_every)
        return scores.sum(), placed.sum(), uc, um, df

    return loop


def _binpack_fit(util_cpu, util_mem, cap_cpu, cap_mem):
    fc = torch.where(cap_cpu > 0, 1.0 - util_cpu / cap_cpu, 0.0)
    fm = torch.where(cap_mem > 0, 1.0 - util_mem / cap_mem, 0.0)
    return torch.clamp(
        20.0 - (torch.pow(10.0, fc) + torch.pow(10.0, fm)), 0.0, 18.0) / 18.0


def make_preemption_apply_loop(k_steps: int, reset_every: int = 0):
    """The preemption cell (batching.py:371-502): each placement tries a
    normal binpack fit; when no node fits, eligible nodes (with
    preemptible lower-priority capacity, preemption.go:96) score
    ``(binpack fit after eviction + preemption score) / 2`` (rank.go:799)
    and the chosen node's preemptible capacity is freed. Evals of a batch
    run against one snapshot; each node's evicted capacity is credited
    once per batch.

    Returns ``fn(shared, used_cpu, used_mem, pre_cpu, pre_mem, pre_score,
    ask_cpu[T,B], ask_mem[T,B], n_steps[B]) -> (score_sum, placed,
    preempted, used_cpu', used_mem')``."""

    def loop(shared: KernelIn, used_cpu, used_mem,
             pre_cpu, pre_mem, pre_score, ask_cpu, ask_mem, n_steps):
        cap_cpu, cap_mem, base = (shared.cap_cpu, shared.cap_mem,
                                  shared.base_mask)
        n = cap_cpu.shape[0]
        iota = torch.arange(n, device=cap_cpu.device)

        def one_batch(planes, asks):
            uc, um, pc, pm = planes
            ac, am = asks[0][:, None], asks[1][:, None]
            ns = n_steps[:, None]
            b = ac.shape[0]
            # every eval's own K-step carry over the shared snapshot
            ucb, umb, pcb, pmb = (x.expand(b, n) for x in (uc, um, pc, pm))
            tot = torch.zeros((3, b), dtype=torch.float32,
                              device=uc.device)
            for i in range(k_steps):
                free_cpu, free_mem = cap_cpu - ucb, cap_mem - umb
                normal = base & (free_cpu >= ac) & (free_mem >= am)
                active = ns > i
                normal_masked = torch.where(
                    normal & active,
                    _binpack_fit(ucb + ac, umb + am, cap_cpu, cap_mem),
                    NEG_INF)
                best_n = _argmax_first(normal_masked)
                val_n = _rows(normal_masked, best_n)
                found_n = val_n > NEG_INF / 2
                # preemption fallback plane (stack.py select_preempting)
                evictable = (pcb > 0) | (pmb > 0)
                pre_ok = (base & evictable & ~normal
                          & ((free_cpu + pcb) >= ac)
                          & ((free_mem + pmb) >= am))
                fite = _binpack_fit(ucb - pcb + ac, umb - pmb + am,
                                    cap_cpu, cap_mem)
                pre_masked = torch.where(pre_ok & active,
                                         (fite + pre_score) / 2.0, NEG_INF)
                best_p = _argmax_first(pre_masked)
                val_p = _rows(pre_masked, best_p)
                found_p = val_p > NEG_INF / 2
                idx = torch.where(found_n, best_n, best_p)
                found = found_n | found_p
                preempted = found_p & ~found_n
                score = torch.where(found_n, val_n,
                                    torch.where(found_p, val_p, 0.0))
                one = ((iota == idx[:, None]).to(torch.float32)
                       * found.to(torch.float32)[:, None])
                evict = one * preempted.to(torch.float32)[:, None]
                ucb = ucb + one * ac - evict * _rows(pcb, idx)[:, None]
                umb = umb + one * am - evict * _rows(pmb, idx)[:, None]
                pcb = pcb * (1.0 - evict)
                pmb = pmb * (1.0 - evict)
                tot = tot + torch.stack([score * found, found.float(),
                                         preempted.float()])
            # commit the placement adds; evicted capacity credited once
            add_uc = torch.sum(ucb - uc + (pc - pcb), dim=0)
            add_um = torch.sum(umb - um + (pm - pmb), dim=0)
            pc3, pm3 = pcb.amin(dim=0), pmb.amin(dim=0)
            stats = (tot[0].sum(), tot[1].sum().to(torch.int64),
                     tot[2].sum().to(torch.int64))
            return (uc + add_uc - (pc - pc3), um + add_um - (pm - pm3),
                    pc3, pm3), stats

        (uc, um, _pc, _pm), (scores, placed, preempted) = _scan_with_reset(
            one_batch, (used_cpu, used_mem, pre_cpu, pre_mem),
            (ask_cpu, ask_mem), reset_every)
        return scores.sum(), placed.sum(), preempted.sum(), uc, um

    return loop
