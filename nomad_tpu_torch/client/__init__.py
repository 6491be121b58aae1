"""Client (node agent) runtime.

Reference behavior: client/ (SURVEY.md section 2.4) -- the node agent:
fingerprints the host into a Node, registers and heartbeats against
servers, watches for assigned allocations with blocking queries, runs
them through allocRunner/TaskRunner hook chains backed by driver
plugins, persists runner state locally for restart recovery, and
reattaches to live tasks after an agent restart.
"""

from nomad_tpu_torch.client.client import Client, ClientConfig, InProcessRPC

__all__ = ["Client", "ClientConfig", "InProcessRPC"]
