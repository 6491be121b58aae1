"""Shared constants: statuses, trigger-bys, scheduler types, operands.

Reference: nomad/structs/structs.go (status/trigger constants are spread
through the Job/Node/Alloc/Eval definitions, e.g. structs.go:4071 area for
job statuses, :10739 area for eval statuses).
"""

# --- Scheduler types (reference scheduler/scheduler.go:24-38) ---
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
JOB_TYPE_SYSBATCH = "sysbatch"
JOB_TYPE_CORE = "_core"

# --- Job statuses ---
JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

# --- Node statuses / scheduling eligibility ---
NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"
NODE_STATUS_DISCONNECTED = "disconnected"
NODE_SCHEDULING_ELIGIBLE = "eligible"
NODE_SCHEDULING_INELIGIBLE = "ineligible"

# --- Alloc desired statuses ---
ALLOC_DESIRED_RUN = "run"
ALLOC_DESIRED_STOP = "stop"
ALLOC_DESIRED_EVICT = "evict"

# --- Alloc client statuses ---
ALLOC_CLIENT_PENDING = "pending"
ALLOC_CLIENT_RUNNING = "running"
ALLOC_CLIENT_COMPLETE = "complete"
ALLOC_CLIENT_FAILED = "failed"
ALLOC_CLIENT_LOST = "lost"
ALLOC_CLIENT_UNKNOWN = "unknown"

# --- Eval statuses (structs.go Evaluation) ---
EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

# --- Eval trigger reasons ---
EVAL_TRIGGER_JOB_REGISTER = "job-register"
EVAL_TRIGGER_JOB_DEREGISTER = "job-deregister"
EVAL_TRIGGER_PERIODIC_JOB = "periodic-job"
EVAL_TRIGGER_NODE_DRAIN = "node-drain"
EVAL_TRIGGER_NODE_UPDATE = "node-update"
EVAL_TRIGGER_ALLOC_STOP = "alloc-stop"
EVAL_TRIGGER_SCHEDULED = "scheduled"
EVAL_TRIGGER_ROLLING_UPDATE = "rolling-update"
EVAL_TRIGGER_DEPLOYMENT_WATCHER = "deployment-watcher"
EVAL_TRIGGER_FAILED_FOLLOW_UP = "failed-follow-up"
EVAL_TRIGGER_MAX_DISCONNECT_TIMEOUT = "max-disconnect-timeout"
EVAL_TRIGGER_MAX_PLAN_ATTEMPTS = "max-plan-attempts"
EVAL_TRIGGER_RETRY_FAILED_ALLOC = "alloc-failure"
EVAL_TRIGGER_QUEUED_ALLOCS = "queued-allocs"
EVAL_TRIGGER_PREEMPTION = "preemption"
EVAL_TRIGGER_SCALING = "job-scaling"
EVAL_TRIGGER_RECONNECT = "reconnect"

# --- Constraint operands (structs.go:8581 area; scheduler/feasible.go:806) ---
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_DISTINCT_PROPERTY = "distinct_property"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"
CONSTRAINT_SEMVER = "semver"
CONSTRAINT_SET_CONTAINS = "set_contains"
CONSTRAINT_SET_CONTAINS_ALL = "set_contains_all"
CONSTRAINT_SET_CONTAINS_ANY = "set_contains_any"
CONSTRAINT_ATTRIBUTE_IS_SET = "is_set"
CONSTRAINT_ATTRIBUTE_IS_NOT_SET = "is_not_set"

# --- Deployment statuses (structs.go Deployment) ---
DEPLOYMENT_STATUS_RUNNING = "running"
DEPLOYMENT_STATUS_PAUSED = "paused"
DEPLOYMENT_STATUS_FAILED = "failed"
DEPLOYMENT_STATUS_SUCCESSFUL = "successful"
DEPLOYMENT_STATUS_CANCELLED = "cancelled"
DEPLOYMENT_STATUS_BLOCKED = "blocked"
DEPLOYMENT_STATUS_UNBLOCKING = "unblocking"
DEPLOYMENT_STATUS_PENDING = "pending"

# --- Scheduler configuration ---
SCHEDULER_ALGORITHM_BINPACK = "binpack"
SCHEDULER_ALGORITHM_SPREAD = "spread"

# Priority bounds (structs.go JobMinPriority/JobDefaultPriority/JobMaxPriority)
JOB_MIN_PRIORITY = 1
JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100
CORE_JOB_PRIORITY = 200

# Max score possible from the bin-packing fit function
# (reference scheduler/rank.go:13-16 binPackingMaxFitScore).
BINPACK_MAX_FIT_SCORE = 18.0
