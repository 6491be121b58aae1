"""Every scenario of ``tests/test_multiregion.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

Multiregion job deployments (structs.go:4133 Multiregion).

A job with a multiregion block fans out into per-region copies over
the federation layer; deployments in regions beyond the strategy's
first max_parallel wave start blocked and unblock only when an
earlier region's deployment succeeds (the deployment watcher's
cross-region kick).
"""

import time

from nomad_tpu_torch import mock, structs
from nomad_tpu_torch.api.agent import Agent, AgentConfig
from nomad_tpu_torch.structs import consts
from _torch_client import port_bridge  # noqa: F401


def wait_for(fn, timeout=25.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError(f"timeout waiting for {msg}")


def make_mr_job(max_parallel=1):
    job = mock.job()
    job.region = "global"
    job.task_groups[0].count = 2
    task = job.task_groups[0].tasks[0]
    task.driver = "mock_driver"
    task.config = {"run_for": 60}
    job.task_groups[0].update = structs.UpdateStrategy(
        max_parallel=2,
        min_healthy_time_s=0.1,
        healthy_deadline_s=10.0,
        progress_deadline_s=60.0,
    )
    job.multiregion = {
        "strategy": {"max_parallel": max_parallel, "on_failure": ""},
        "regions": [
            {"name": "east", "count": 1, "datacenters": []},
            {"name": "west", "count": 1, "datacenters": []},
        ],
    }
    return job


class TestMultiregion:
    def test_two_region_rollout_gates_on_first_region(self):
        east = Agent(AgentConfig.dev(device="cpu",
                                     name="east-1", region="east"))
        west = Agent(AgentConfig.dev(device="cpu",
                                     name="west-1", region="west"))
        east.start()
        west.start()
        try:
            east.server.join_region("west", west.http.addr)
            west.server.join_region("east", east.http.addr)

            job = make_mr_job(max_parallel=1)
            out = east.server.job_register(job)
            assert sorted(out["regions"]) == ["east", "west"]

            # both regions got their copy, with the per-region count
            e_job = wait_for(
                lambda: east.server.state.snapshot().job_by_id(
                    job.namespace, job.id), msg="east job")
            w_job = wait_for(
                lambda: west.server.state.snapshot().job_by_id(
                    job.namespace, job.id), msg="west job")
            assert e_job.region == "east" and w_job.region == "west"
            assert e_job.task_groups[0].count == 1
            assert w_job.task_groups[0].count == 1

            # west's deployment starts blocked; east's runs
            w_dep = wait_for(
                lambda: west.server.state.snapshot()
                .latest_deployment_by_job_id(job.namespace, job.id),
                msg="west deployment")
            assert w_dep.status == consts.DEPLOYMENT_STATUS_BLOCKED
            # the gate is real: while blocked, west placed NOTHING
            assert west.server.state.snapshot().allocs_by_job(
                job.namespace, job.id) == []

            # while east is still rolling, west must not place allocs
            # beyond the gate (its reconciler treats blocked as paused)
            e_dep = wait_for(
                lambda: east.server.state.snapshot()
                .latest_deployment_by_job_id(job.namespace, job.id),
                msg="east deployment")
            assert e_dep.status != consts.DEPLOYMENT_STATUS_BLOCKED

            # east succeeds -> watcher kicks west's gate open
            wait_for(
                lambda: east.server.state.snapshot()
                .latest_deployment_by_job_id(job.namespace, job.id).status
                == consts.DEPLOYMENT_STATUS_SUCCESSFUL,
                timeout=40, msg="east deployment successful")
            wait_for(
                lambda: west.server.state.snapshot()
                .latest_deployment_by_job_id(job.namespace, job.id).status
                != consts.DEPLOYMENT_STATUS_BLOCKED,
                timeout=40, msg="west deployment unblocked")
            # and west then completes its own rollout
            wait_for(
                lambda: west.server.state.snapshot()
                .latest_deployment_by_job_id(job.namespace, job.id).status
                == consts.DEPLOYMENT_STATUS_SUCCESSFUL,
                timeout=40, msg="west deployment successful")
        finally:
            east.shutdown()
            west.shutdown()

    def test_region_failure_fails_downstream_regions(self):
        """Default on_failure (''): a region's deployment failure fails
        every region after it in the rollout order; regions before it
        keep their result (structs.go:4133 on_failure semantics).

        West is starved (datacenters override no node matches), so its
        deployment blows the progress deadline after east's success
        unblocks it; central — still gated behind west — must then be
        failed by the cross-region propagation, not left blocked."""
        east = Agent(AgentConfig.dev(device="cpu",
                                     name="east-3", region="east"))
        west = Agent(AgentConfig.dev(device="cpu",
                                     name="west-3", region="west"))
        central = Agent(AgentConfig.dev(device="cpu",
                                        name="central-3", region="central"))
        agents = [east, west, central]
        for a in agents:
            a.start()
        try:
            for a in agents:
                for b in agents:
                    if a is not b:
                        a.server.join_region(b.config.region, b.http.addr)
            job = make_mr_job(max_parallel=1)
            job.task_groups[0].update.progress_deadline_s = 2.0
            job.multiregion["regions"] = [
                {"name": "east", "count": 1, "datacenters": []},
                {"name": "west", "count": 1, "datacenters": ["nowhere"]},
                {"name": "central", "count": 1, "datacenters": []},
            ]
            east.server.job_register(job)

            def dep_status(agent):
                d = agent.server.state.snapshot() \
                    .latest_deployment_by_job_id(job.namespace, job.id)
                return d.status if d else None

            wait_for(lambda: dep_status(east)
                     == consts.DEPLOYMENT_STATUS_SUCCESSFUL,
                     timeout=40, msg="east successful")
            wait_for(lambda: dep_status(west)
                     == consts.DEPLOYMENT_STATUS_FAILED,
                     timeout=40, msg="west failed")
            wait_for(lambda: dep_status(central)
                     == consts.DEPLOYMENT_STATUS_FAILED,
                     timeout=40, msg="central failed by propagation")
            # east keeps its success — default on_failure only fails
            # DOWNSTREAM regions
            assert dep_status(east) == consts.DEPLOYMENT_STATUS_SUCCESSFUL
        finally:
            for a in agents:
                a.shutdown()

    def test_region_failure_fail_local_leaves_others_blocked(self):
        """on_failure='fail_local': only the failing region fails; the
        downstream region stays blocked awaiting operator action."""
        east = Agent(AgentConfig.dev(device="cpu",
                                     name="east-4", region="east"))
        west = Agent(AgentConfig.dev(device="cpu",
                                     name="west-4", region="west"))
        central = Agent(AgentConfig.dev(device="cpu",
                                        name="central-4", region="central"))
        agents = [east, west, central]
        for a in agents:
            a.start()
        try:
            for a in agents:
                for b in agents:
                    if a is not b:
                        a.server.join_region(b.config.region, b.http.addr)
            job = make_mr_job(max_parallel=1)
            job.task_groups[0].update.progress_deadline_s = 2.0
            job.multiregion["strategy"]["on_failure"] = "fail_local"
            job.multiregion["regions"] = [
                {"name": "east", "count": 1, "datacenters": []},
                {"name": "west", "count": 1, "datacenters": ["nowhere"]},
                {"name": "central", "count": 1, "datacenters": []},
            ]
            east.server.job_register(job)

            def dep_status(agent):
                d = agent.server.state.snapshot() \
                    .latest_deployment_by_job_id(job.namespace, job.id)
                return d.status if d else None

            wait_for(lambda: dep_status(west)
                     == consts.DEPLOYMENT_STATUS_FAILED,
                     timeout=40, msg="west failed")
            time.sleep(2.0)   # propagation would have landed by now
            assert dep_status(central) == consts.DEPLOYMENT_STATUS_BLOCKED
        finally:
            for a in agents:
                a.shutdown()

    def test_max_parallel_zero_runs_all_regions(self):
        east = Agent(AgentConfig.dev(device="cpu",
                                     name="east-2", region="east"))
        west = Agent(AgentConfig.dev(device="cpu",
                                     name="west-2", region="west"))
        east.start()
        west.start()
        try:
            east.server.join_region("west", west.http.addr)
            west.server.join_region("east", east.http.addr)
            job = make_mr_job(max_parallel=0)
            east.server.job_register(job)
            for agent in (east, west):
                dep = wait_for(
                    lambda a=agent: a.server.state.snapshot()
                    .latest_deployment_by_job_id(job.namespace, job.id),
                    msg="deployment")
                assert dep.status != consts.DEPLOYMENT_STATUS_BLOCKED
        finally:
            east.shutdown()
            west.shutdown()
