"""HTTP API surface: agent routes, JSON codec, SDK client.

Reference: command/agent/http.go (/v1 routes :321-411), api/api.go
(Go SDK :448). The agent serves both server-backed and client-backed
routes from one process, mirroring the reference's merged agent.
"""
