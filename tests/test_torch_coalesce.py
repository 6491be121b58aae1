"""The port's wave launcher and coalescer against the JAX reference (CPU).

The same member kins go through ``nomad_tpu.parallel.coalesce.launch_wave``
and the port's ``launch_wave(device="cpu")``; every member's KernelOut
must agree (choices, found, top-k indices and metrics exactly, scores
within ``SCORE_ATOL``), over the shared, stacked and mixed layouts.
The placement turn (the port's, for worker processes) is held by a
wave's members until each has left its plan window, and a holder never
waits on itself.
"""

import threading
import time

import numpy as np
import pytest
import torch

import _torch_parity as tp
from nomad_tpu.parallel import coalesce as ref_coalesce
from nomad_tpu_torch.convert import kernel_in_from_numpy
from nomad_tpu_torch.ops import cuda_kernel as ck
from nomad_tpu_torch.ops import kernel as tk
from nomad_tpu_torch.parallel import coalesce as pc


def _port_kins(kins):
    return [kernel_in_from_numpy(k, keep_numpy=True) for k in kins]


def _share(kins, fields):
    """Make every member hold member 0's object for ``fields``."""
    return [k._replace(**{f: getattr(kins[0], f) for f in fields})
            for k in kins]


def _layout(kins, layout):
    if layout == "shared":
        kins = _share(kins, pc._SHAREABLE_FIELDS + pc._JOB_SHAREABLE_FIELDS
                      + pc._NEUTRAL_SHAREABLE_FIELDS)
    elif layout == "mixed":
        kins = _share(kins, pc._SHAREABLE_FIELDS)
    return kins


def _assert_outs(port_outs, ref_outs, ctx):
    assert len(port_outs) == len(ref_outs)
    for i, (p, r) in enumerate(zip(port_outs, ref_outs)):
        c = f"{ctx} member={i}"
        for name in ("chosen", "found", "topk_idx") + tk.FUSED_METRIC_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(p, name)), np.asarray(getattr(r, name)),
                err_msg=f"{name} {c}")
        for name in ("scores", "topk_scores"):
            np.testing.assert_allclose(
                np.asarray(getattr(p, name)), np.asarray(getattr(r, name)),
                rtol=0, atol=tp.SCORE_ATOL, err_msg=f"{name} {c}")


@pytest.mark.parametrize("layout", ["shared", "stacked", "mixed"])
@pytest.mark.parametrize("variant,n_nodes", tp.FUSED_VARIANTS,
                         ids=[v for v, _ in tp.FUSED_VARIANTS])
def test_launch_wave_matches_reference(variant, n_nodes, layout):
    kins, feats = tp.wave_members(11, variant, n_nodes, b=3)
    kins = _layout(kins, layout)
    steps = [tp.K, tp.K - 1, tp.K]
    ref = ref_coalesce.launch_wave(kins, steps, [feats] * len(kins))
    pc.fused_wave_stats.reset()
    port = pc.launch_wave(_port_kins(kins), steps,
                          [tp.port_features(feats)] * len(kins),
                          device="cpu")
    _assert_outs(port, ref, f"variant={variant} layout={layout}")
    assert pc.fused_wave_stats.snapshot() == {"launches": 1, "fallbacks": 0,
                                              "failures": 0}


def test_launch_wave_composite_fallback_counted():
    kins, feats = tp.wave_members(12, "spread", 200, b=2)
    steps = [tp.K] * 2
    ref = ref_coalesce.launch_wave(kins, steps, [feats] * 2)
    pc.fused_wave_stats.reset()
    port = pc.launch_wave(_port_kins(kins), steps,
                          [tp.port_features(feats)] * 2, device="cpu")
    _assert_outs(port, ref, "spread")
    assert pc.fused_wave_stats.snapshot() == {"launches": 0, "fallbacks": 1,
                                              "failures": 0}


def test_shared_leaf_uploads_once_per_wave():
    kins, feats = tp.wave_members(13, "shuffle", 200, b=4)
    kins = _layout(kins, "mixed")
    pc.upload_stats.reset()
    pc.launch_wave(_port_kins(kins), [tp.K] * 4,
                   [tp.port_features(feats)] * 4, device="cpu")
    # one upload per KernelIn leaf (shared or member-stacked) plus the
    # two step maps: never one per member
    assert pc.upload_stats.uploads == len(tk.KernelIn._fields) + 2
    def group_shared(fields):
        return all(getattr(k, f) is getattr(kins[0], f)
                   for k in kins for f in fields)

    flags = [group_shared(g) for g in (pc._SHAREABLE_FIELDS,
                                       pc._NEUTRAL_SHAREABLE_FIELDS,
                                       pc._JOB_SHAREABLE_FIELDS)]
    assert flags[0]
    want = 2 * 4 * tk.pad_steps(4 * tp.K)
    for f in tk.KernelIn._fields:
        copies = 1 if pc.wave_field_is_shared(f, *flags) else 4
        want += np.asarray(getattr(kins[0], f)).nbytes * copies
    assert pc.upload_stats.bytes == want


def test_resident_tensor_leaf_moves_nothing():
    kins, feats = tp.wave_members(14, "lean", 60, b=2)
    kins = _layout(_port_kins(kins), "shared")
    resident = torch.tensor(np.asarray(kins[0].used_cpu))
    kins = [k._replace(used_cpu=resident) for k in kins]
    pc.upload_stats.reset()
    pc.launch_wave(kins, [tp.K] * 2, [tp.port_features(feats)] * 2,
                   device="cpu")
    # the frozen neutral singletons among the shared leaves are resident
    # too (tensors/device_state): they move nothing either
    frozen = sum(1 for f in (pc._NEUTRAL_SHAREABLE_FIELDS
                             + pc._JOB_SHAREABLE_FIELDS)
                 if not getattr(kins[0], f).flags.writeable)
    assert frozen > 0
    assert pc.upload_stats.uploads == len(tk.KernelIn._fields) + 1 - frozen


def test_resident_usage_commits_the_wave():
    kins, feats = tp.wave_members(15, "lean", 60, b=2)
    kins = _layout(_port_kins(kins), "shared")
    k0 = kins[0]
    res = pc.ResidentUsage(k0.used_cpu, k0.used_mem, k0.used_disk,
                           device="cpu")
    before = res.used_cpu
    outs = pc.launch_wave(kins, [tp.K] * 2, [tp.port_features(feats)] * 2,
                          device="cpu", resident=res)
    assert res.commits == 1 and res.used_cpu is not before
    want = np.asarray(k0.used_cpu).copy()
    for o in outs:
        for c in o.chosen[o.found]:
            want[c] += np.float32(k0.ask_cpu) if o is outs[0] else \
                np.float32(kins[1].ask_cpu)
    np.testing.assert_allclose(res.used_cpu.numpy(), want, rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(before.numpy(), np.asarray(k0.used_cpu))


def test_fused_wave_apply_leaves_inputs_untouched():
    kins, feats = tp.wave_members(16, "kitchen_sink", 383)
    stacked, sm, sl, t_pad = tp.stack_wave(kins)
    kin = kernel_in_from_numpy(stacked, device="cpu")
    n = kin.cap_cpu.shape[-1]
    uc = torch.arange(n, dtype=torch.float32) * 3.0
    um = torch.full((n,), 64.0)
    ud = torch.zeros(n)
    copies = [x.clone() for x in (uc, um, ud)] + [x.clone() for x in kin]
    out, uc2, um2, ud2 = ck.fused_wave_apply(
        kin, uc, um, ud, sm, sl, t_pad, tp.port_features(feats))
    for x, c in zip((uc, um, ud) + tuple(kin), copies):
        torch.testing.assert_close(x, c, rtol=0, atol=0)
    torch.testing.assert_close(uc2, uc + out.a_cpu)
    torch.testing.assert_close(um2, um + out.a_mem)
    torch.testing.assert_close(ud2, ud + out.a_disk)
    assert uc2.data_ptr() != uc.data_ptr()


def test_coalescer_threads_form_one_wave():
    """N threads park in the coalescer; the wave fires once and each
    member gets its own slice (equal to its reference slice)."""
    kins, feats = tp.wave_members(17, "penalty_preferred", 383, b=4)
    kins = _layout(kins, "mixed")
    steps = [tp.K, tp.K - 2, tp.K, tp.K - 1]
    ref = ref_coalesce.launch_wave(kins, steps, [feats] * 4)
    port_kins = _port_kins(kins)
    co = pc.LaunchCoalescer(4, device="cpu", adaptive=False)
    outs = [None] * 4
    errors = []

    def member(i):
        try:
            outs[i] = co.launch(port_kins[i], steps[i],
                                tp.port_features(feats))
        except BaseException as e:    # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            co.done()

    threads = [threading.Thread(target=member, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert co.launches == 1 and co.max_wave == 4 and co.requests == 4
    for i, k in enumerate(steps):
        assert len(outs[i].chosen) == k
    _assert_outs(outs, ref, "coalescer")


def test_coalescer_propagates_kernel_errors():
    """An error from the wave reaches every parked member; nothing falls
    back."""
    kins, feats = tp.wave_members(18, "lean", 60, b=2)
    bad = _port_kins(kins)
    bad[1] = bad[1]._replace(cap_cpu=np.zeros(7, np.float32))
    co = pc.LaunchCoalescer(2, device="cpu", adaptive=False)
    errors = []

    def member(i):
        try:
            co.launch(bad[i], tp.K, tp.port_features(feats))
        except Exception as e:        # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            co.done()

    threads = [threading.Thread(target=member, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    # the two members sit on different node axes: two waves, and the
    # malformed one fails on its own
    assert co.launches == 2
    assert len(errors) == 1


def test_topk_slices_resolve_once():
    kins, feats = tp.wave_members(19, "shuffle", 200, b=2)
    outs = pc.launch_wave(_port_kins(kins), [tp.K] * 2,
                          [tp.port_features(feats)] * 2, device="cpu")
    a = np.asarray(outs[0].topk_idx)
    b = np.asarray(outs[1].topk_scores)
    assert a.shape == (tp.K, tk.TOPK) and b.shape == (tp.K, tk.TOPK)
    assert outs[0].topk_idx._wave is outs[1].topk_idx._wave
    assert len(outs[1].topk_idx) == tp.K


def test_wave_stats_and_union_features():
    f1 = tk.LEAN_FEATURES._replace(with_ports=True)
    f2 = tk.LEAN_FEATURES._replace(with_shuffle=True, n_spreads=1)
    u = pc.union_features([f1, f2])
    assert u.with_ports and u.with_shuffle and u.n_spreads == tk.MAX_SPREADS
    ref = ref_coalesce.union_features([
        ref_coalesce.KernelFeatures(**f1._asdict()),
        ref_coalesce.KernelFeatures(**f2._asdict())])
    assert u._asdict() == ref._asdict()
    st = pc.WaveStats()
    st.observe_wave(3, False)
    st.observe_wave(32, True)
    for s in (0.001, 0.002, 0.003):
        st.observe_park(s)
        st.observe_assemble(2 * s)
    snap = st.snapshot()
    assert snap["launches"] == 2 and snap["deadline_launches"] == 1
    assert snap["fill_ratio"] == pytest.approx(35 / 36)
    assert snap["park_latency_p50_ms"] == pytest.approx(2.0)
    assert snap["assemble_latency_p50_ms"] == pytest.approx(4.0)
    st.reset()
    assert st.snapshot()["assemble_latency_p99_ms"] == 0.0


def test_wave_field_groups_match_reference():
    assert pc._SHAREABLE_FIELDS == ref_coalesce._SHAREABLE_FIELDS
    assert pc._NEUTRAL_SHAREABLE_FIELDS == \
        ref_coalesce._NEUTRAL_SHAREABLE_FIELDS
    assert pc._JOB_SHAREABLE_FIELDS == ref_coalesce._JOB_SHAREABLE_FIELDS
    for f in tk.KernelIn._fields:
        for flags in ((True, True, True), (False, True, False),
                      (True, False, True)):
            assert pc.wave_field_is_shared(f, *flags) == \
                ref_coalesce.wave_field_is_shared(f, *flags)



def test_suspended_participant_does_not_hold_the_wave():
    """A participant that suspends (blocked outside the hot path) stops
    the others from waiting for it; resume re-takes the slot."""
    kins, feats = tp.wave_members(23, "lean", 60, b=2)
    pk = _port_kins(kins)
    co = pc.LaunchCoalescer(3, device="cpu", adaptive=False)
    co.suspend()                 # participant 2 leaves for the applier
    outs = [None] * 2

    def member(i):
        try:
            outs[i] = co.launch(pk[i], tp.K, tp.port_features(feats))
        finally:
            co.done()

    threads = [threading.Thread(target=member, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert co.launches == 1 and co.max_wave == 2
    assert all(o is not None and len(o.chosen) == tp.K for o in outs)
    co.resume()
    out = co.launch(pk[0], tp.K, tp.port_features(feats))
    assert co.launches == 2 and len(out.chosen) == tp.K


class _MutexTurn:
    """A placement turn held by one wave at a time (the owner's lock), whose
    ``begin`` hands the members the inputs ``refresh`` makes."""

    def __init__(self, refresh=None, error=None):
        self._lock = threading.Semaphore(1)
        self.refresh = refresh
        self.error = error
        self.begins = 0
        self.ends = 0

    def begin(self, kins):
        if self.error is not None:
            raise self.error
        assert self._lock.acquire(timeout=30), "turn never given back"
        self.begins += 1
        return [self.refresh(k) for k in kins] if self.refresh else kins

    def end(self):
        self.ends += 1
        self._lock.release()


def _members(co, kins, feats, body):
    """One thread per member: launch, then ``body(i, out)``, then done."""
    outs, errors = [None] * len(kins), []

    def member(i):
        try:
            outs[i] = co.launch(kins[i], tp.K, tp.port_features(feats))
            body(i, outs[i])
        except BaseException as e:    # noqa: BLE001 - asserted by callers
            errors.append(e)
        finally:
            co.done()

    threads = [threading.Thread(target=member, args=(i,))
               for i in range(len(kins))]
    for th in threads:
        th.start()
    return threads, outs, errors


def test_turn_places_on_refreshed_inputs_until_every_plan_is_in():
    """A wave under a placement turn runs on the inputs ``begin`` returns,
    and the turn ends once, after the last member leaves its plan
    window."""
    kins, feats = tp.wave_members(31, "lean", 120, b=3)
    pk = _port_kins(_layout(kins, "mixed"))
    fuller = pk[0].used_cpu + np.float32(0.5) * (pk[0].cap_cpu
                                                 - pk[0].used_cpu)
    turn = _MutexTurn(refresh=lambda k: k._replace(used_cpu=fuller))
    co = pc.LaunchCoalescer(3, device="cpu", adaptive=False, turn=turn)
    inside, leave = threading.Barrier(4), threading.Event()

    def plan(i, out):
        with co.plan_window():
            inside.wait(timeout=30)
            assert leave.wait(timeout=30)

    threads, outs, errors = _members(co, pk, feats, plan)
    inside.wait(timeout=30)
    assert turn.begins == 1 and turn.ends == 0    # plans not yet in
    leave.set()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert co.launches == 1 and turn.ends == 1
    want = pc.launch_wave([k._replace(used_cpu=fuller) for k in pk],
                          [tp.K] * 3, [tp.port_features(feats)] * 3,
                          device="cpu")
    for got, exp in zip(outs, want):
        np.testing.assert_array_equal(got.chosen, exp.chosen)
        np.testing.assert_array_equal(got.found, exp.found)


def test_turn_error_fails_every_member():
    """A turn that cannot be had fails each member of the wave with its
    error; nothing launches."""
    kins, feats = tp.wave_members(32, "lean", 60, b=2)
    turn = _MutexTurn(error=TimeoutError("turn held elsewhere"))
    co = pc.LaunchCoalescer(2, device="cpu", adaptive=False, turn=turn)
    threads, _, errors = _members(co, _port_kins(kins), feats,
                                  lambda i, out: None)
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert co.launches == 0 and turn.ends == 0
    assert len(errors) == 2 and all(isinstance(e, TimeoutError)
                                    for e in errors)


def test_turn_holder_entering_its_plan_window_does_not_wait_on_itself():
    """A member that holds the turn and completes the next wave's
    rendezvous by entering its plan window does not wait for the turn it
    holds: that wave fires on a thread of its own once the plan is in."""
    kins, feats = tp.wave_members(33, "lean", 60, b=2)
    pk = _port_kins(kins)
    turn = _MutexTurn()
    co = pc.LaunchCoalescer(2, device="cpu", adaptive=False, turn=turn)
    co.suspend()                 # the second member starts later
    outs, errors = [None] * 2, []

    def first():
        try:
            outs[0] = co.launch(pk[0], tp.K, tp.port_features(feats))
            second.start()
            deadline = time.time() + 30
            while not co._pending and time.time() < deadline:
                time.sleep(0.005)
            with co.plan_window():        # completes the second wave
                time.sleep(0.05)
        except BaseException as e:        # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            co.done()

    def run_second():
        try:
            co.resume()
            outs[1] = co.launch(pk[1], tp.K, tp.port_features(feats))
        except BaseException as e:        # noqa: BLE001 - asserted below
            errors.append(e)
        finally:
            co.done()

    second = threading.Thread(target=run_second)
    one = threading.Thread(target=first)
    one.start()
    one.join(timeout=60)
    second.join(timeout=60)
    assert not one.is_alive() and not second.is_alive()
    assert not errors, errors
    assert co.launches == 2 and turn.begins == 2 and turn.ends == 2
    assert all(o is not None and len(o.chosen) == tp.K for o in outs)
