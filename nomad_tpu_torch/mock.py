"""Mock factories for tests and benchmarks.

Reference behavior: nomad/mock/mock.go -- mock.Node(), mock.Job(),
mock.Alloc(), mock.Eval(), mock.SystemJob() with the same default shapes
(4000 MHz / 8192 MB nodes; 500 MHz / 256 MB tasks) so scheduler tests port
over with identical arithmetic.
"""

from __future__ import annotations

import itertools
import uuid

from nomad_tpu_torch import structs
from nomad_tpu_torch.structs import consts

_counter = itertools.count()


def _uuid() -> str:
    return str(uuid.uuid4())


def node(**overrides) -> structs.Node:
    """mock.Node(): 4000 MHz cpu, 8192 MB mem, 100 GB disk, 1000 mbit net."""
    i = next(_counter)
    n = structs.Node(
        id=_uuid(),
        name=f"foobar-{i}",
        datacenter="dc1",
        node_class="",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "1.3.0",
            "driver.exec": "1",
            "driver.mock_driver": "1",
            "cpu.numcores": "4",
        },
        node_resources=structs.NodeResources(
            cpu=structs.NodeCpuResources(
                cpu_shares=4000,
                total_core_count=4,
                reservable_cpu_cores=[0, 1, 2, 3],
            ),
            memory=structs.NodeMemoryResources(memory_mb=8192),
            disk=structs.NodeDiskResources(disk_mb=100 * 1024),
            networks=[
                structs.NetworkResource(
                    device="eth0", cidr="192.168.0.100/32", ip="192.168.0.100",
                    mbits=1000,
                )
            ],
        ),
        reserved_resources=structs.NodeReservedResources(
            cpu_shares=100, memory_mb=256, disk_mb=4 * 1024,
            networks_ports=[22],
        ),
        drivers={
            "exec": structs.DriverInfo(detected=True, healthy=True),
            "mock_driver": structs.DriverInfo(detected=True, healthy=True),
        },
        status=consts.NODE_STATUS_READY,
    )
    for k, v in overrides.items():
        setattr(n, k, v)
    n.compute_class()
    return n


def job(**overrides) -> structs.Job:
    """mock.Job(): service job, 1 TG x count 10, 1 task (500 MHz/256 MB)."""
    j = structs.Job(
        id=f"mock-service-{_uuid()}",
        name="my-job",
        type=consts.JOB_TYPE_SERVICE,
        priority=50,
        datacenters=["dc1"],
        constraints=[
            structs.Constraint(
                ltarget="${attr.kernel.name}", rtarget="linux", operand="="
            )
        ],
        task_groups=[
            structs.TaskGroup(
                name="web",
                count=10,
                ephemeral_disk=structs.EphemeralDisk(size_mb=150),
                restart_policy=structs.RestartPolicy(
                    attempts=3, interval_s=600, delay_s=60, mode="delay"
                ),
                reschedule_policy=structs.ReschedulePolicy(
                    attempts=2, interval_s=600, delay_s=5,
                    delay_function="constant",
                ),
                tasks=[
                    structs.Task(
                        name="web",
                        driver="exec",
                        config={"command": "/bin/date"},
                        env={"FOO": "bar"},
                        resources=structs.Resources(
                            cpu=500, memory_mb=256,
                            networks=[
                                structs.NetworkResource(
                                    mbits=50,
                                    dynamic_ports=[
                                        structs.Port(label="http"),
                                        structs.Port(label="admin"),
                                    ],
                                )
                            ],
                        ),
                        meta={"foo": "bar"},
                    )
                ],
                meta={"elb_check_type": "http"},
            )
        ],
        meta={"owner": "armon"},
        status=consts.JOB_STATUS_PENDING,
        version=0,
        create_index=42,
        modify_index=99,
        job_modify_index=99,
    )
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def simple_job(**overrides) -> structs.Job:
    """A cpu/mem-only job (no ports) -- the pure binpack bench shape."""
    j = job()
    j.constraints = []
    tg = j.task_groups[0]
    tg.tasks[0].resources = structs.Resources(cpu=500, memory_mb=256)
    tg.tasks[0].driver = "mock_driver"
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def system_job(**overrides) -> structs.Job:
    j = structs.Job(
        id=f"mock-system-{_uuid()}",
        name="my-job",
        type=consts.JOB_TYPE_SYSTEM,
        priority=100,
        datacenters=["dc1"],
        constraints=[
            structs.Constraint(
                ltarget="${attr.kernel.name}", rtarget="linux", operand="="
            )
        ],
        task_groups=[
            structs.TaskGroup(
                name="web",
                count=1,
                restart_policy=structs.RestartPolicy(
                    attempts=3, interval_s=600, delay_s=60, mode="delay"
                ),
                ephemeral_disk=structs.EphemeralDisk(size_mb=50),
                tasks=[
                    structs.Task(
                        name="web",
                        driver="exec",
                        config={"command": "/bin/date"},
                        resources=structs.Resources(cpu=500, memory_mb=256),
                    )
                ],
            )
        ],
        status=consts.JOB_STATUS_PENDING,
    )
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def batch_job(**overrides) -> structs.Job:
    j = job()
    j.type = consts.JOB_TYPE_BATCH
    j.id = f"mock-batch-{_uuid()}"
    tg = j.task_groups[0]
    tg.tasks[0].resources = structs.Resources(cpu=500, memory_mb=256)
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def eval(**overrides) -> structs.Evaluation:
    e = structs.Evaluation(
        namespace="default",
        priority=50,
        type=consts.JOB_TYPE_SERVICE,
        job_id=_uuid(),
        status=consts.EVAL_STATUS_PENDING,
        triggered_by=consts.EVAL_TRIGGER_JOB_REGISTER,
    )
    for k, v in overrides.items():
        setattr(e, k, v)
    return e


def alloc(**overrides) -> structs.Allocation:
    j = job()
    a = structs.Allocation(
        id=_uuid(),
        eval_id=_uuid(),
        node_id="12345678-abcd-efab-cdef-123456789abc",
        namespace="default",
        task_group="web",
        job_id=j.id,
        job=j,
        name="my-job.web[0]",
        desired_status=consts.ALLOC_DESIRED_RUN,
        client_status=consts.ALLOC_CLIENT_PENDING,
        allocated_resources=structs.AllocatedResources(
            tasks={
                "web": structs.AllocatedTaskResources(
                    cpu=structs.AllocatedCpuResources(cpu_shares=500),
                    memory=structs.AllocatedMemoryResources(memory_mb=256),
                )
            },
            shared=structs.AllocatedSharedResources(disk_mb=150),
        ),
    )
    for k, v in overrides.items():
        setattr(a, k, v)
    if "job" not in overrides and "job_id" in overrides:
        a.job = None
    return a
