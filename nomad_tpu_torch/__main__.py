"""`python -m nomad_tpu_torch` — the single-binary entry point (main.go:80)."""

import sys

from nomad_tpu_torch.cli import main

sys.exit(main())
