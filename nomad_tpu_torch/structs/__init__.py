"""Core data model (reference: nomad/structs/).

Python dataclasses for the orchestration currency -- Job/TaskGroup/Task,
Node, Allocation, Evaluation, Plan -- plus the resource math that the
scheduler kernel reproduces on device (reference nomad/structs/funcs.go).
"""

from nomad_tpu_torch.structs.consts import *  # noqa: F401,F403
from nomad_tpu_torch.structs.resources import (  # noqa: F401
    AllocatedCpuResources,
    AllocatedDeviceResource,
    AllocatedMemoryResources,
    AllocatedResources,
    AllocatedSharedResources,
    AllocatedTaskResources,
    ComparableResources,
    NodeCpuResources,
    NodeDeviceResource,
    NodeDiskResources,
    NodeMemoryResources,
    NodeReservedResources,
    NodeResources,
    RequestedDevice,
    Resources,
    allocs_fit,
    compute_free_percentage,
    score_fit_binpack,
    score_fit_spread,
)
from nomad_tpu_torch.structs.network import (  # noqa: F401
    NetworkIndex,
    NetworkResource,
    Port,
    PortBitmap,
)
from nomad_tpu_torch.structs.constraints import (  # noqa: F401
    Affinity,
    Constraint,
    Spread,
    SpreadTarget,
    check_constraint,
    resolve_target,
)
from nomad_tpu_torch.structs.job import (  # noqa: F401
    EphemeralDisk,
    Job,
    MigrateStrategy,
    PeriodicConfig,
    ReschedulePolicy,
    RestartPolicy,
    ScalingPolicy,
    Service,
    Task,
    TaskGroup,
    TaskLifecycleConfig,
    UpdateStrategy,
    VolumeRequest,
)
from nomad_tpu_torch.structs.csi import (  # noqa: F401
    CSIPlugin,
    CSIVolume,
    CSIVolumeCapability,
    CSIVolumeClaim,
)
from nomad_tpu_torch.structs.node import DriverInfo, Node  # noqa: F401
from nomad_tpu_torch.structs.alloc import (  # noqa: F401
    AllocMetric,
    Allocation,
    DesiredTransition,
    RescheduleEvent,
    RescheduleTracker,
    TaskEvent,
    TaskState,
)
from nomad_tpu_torch.structs.eval_plan import (  # noqa: F401
    Deployment,
    DeploymentState,
    Evaluation,
    Plan,
    PlanAnnotations,
    PlanResult,
)
