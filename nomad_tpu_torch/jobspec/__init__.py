"""Job specification parsing: HCL2-subset + JSON.

Reference: jobspec/ (HCL1, parse.go:26) and jobspec2/ (HCL2,
parse.go:19-40). The from-scratch parser in hcl.py covers the jobspec
grammar (blocks, attributes, lists, objects, heredocs, comments);
parse.py maps the syntax tree onto the Job structs.
"""

from nomad_tpu_torch.jobspec.parse import parse_hcl, parse_json  # noqa: F401
