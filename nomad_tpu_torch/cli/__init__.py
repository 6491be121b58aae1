"""CLI verb tree over the /v1 SDK (reference: command/ + main.go)."""

from nomad_tpu_torch.cli.main import main  # noqa: F401
