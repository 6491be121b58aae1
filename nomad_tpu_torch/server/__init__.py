"""Server runtime: broker, blocked evals, planner, workers, leader.

Reference behavior: nomad/ (SURVEY.md section 2.3) -- the server-side
machinery around the scheduler: EvalBroker (eval_broker.go), BlockedEvals
(blocked_evals.go), PlanQueue + plan applier (plan_queue.go,
plan_apply.go), Workers (worker.go), heartbeats (heartbeat.go), and the
Server that wires them together (server.go, leader.go).
"""

from nomad_tpu_torch.server.blocked_evals import BlockedEvals
from nomad_tpu_torch.server.eval_broker import EvalBroker
from nomad_tpu_torch.server.plan_queue import PlanQueue
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.server.worker import Worker

__all__ = [
    "BlockedEvals",
    "EvalBroker",
    "PlanQueue",
    "Server",
    "ServerConfig",
    "Worker",
]
