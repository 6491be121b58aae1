"""ACL system: policies, tokens, compiled capability sets.

Reference: acl/acl.go (ACL object :43), acl/policy.go (HCL policy
parsing), nomad/acl.go (ResolveToken), enforced per-endpoint.
"""

from nomad_tpu_torch.acl.acl import ACL, ANONYMOUS_ACL, MANAGEMENT_ACL  # noqa: F401
from nomad_tpu_torch.acl.policy import ACLPolicy, ACLToken, parse_policy  # noqa: F401
from nomad_tpu_torch.acl.resolver import TokenResolver  # noqa: F401
