"""Device allocation: exact host-side assignment + kernel plane builder.

Reference behavior: scheduler/device.go (deviceAllocator, AssignDevice
:32 -- pick the feasible group with the highest normalized affinity
score, return matched weights) and feasible.go DeviceChecker (:1193).

Split of labor in the TPU build: the kernel checks *count* feasibility
via ``dev_free[N, R]`` planes (max free instances in any single matching
group per request) and scores ``dev_aff_score[N]`` (class-memoizable);
after the kernel selects a node, ``assign_devices`` performs the exact
per-instance assignment the reference does, and the stack retries with
the node masked out in the rare case exactness disagrees with the
plane approximation (overlapping requests on one group).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from nomad_tpu_torch.structs.constraints import check_constraint
from nomad_tpu_torch.structs.resources import (
    AllocatedDeviceResource,
    DeviceAccounter,
    NodeDeviceResource,
    RequestedDevice,
)


def resolve_device_target(target: str, dev: NodeDeviceResource):
    """feasible.go resolveDeviceTarget: ${device.attr.*} and intrinsics."""
    if target == "${device.model}":
        return dev.name, True
    if target == "${device.vendor}":
        return dev.vendor, True
    if target == "${device.type}":
        return dev.type, True
    if target.startswith("${device.attr."):
        attr = target[len("${device.attr."):].rstrip("}")
        val = dev.attributes.get(attr)
        return (val, True) if val is not None else (None, False)
    return target, True


def node_device_matches(dev: NodeDeviceResource, req: RequestedDevice) -> bool:
    """feasible.go nodeDeviceMatches: ID match + constraints."""
    if not dev.matches_request(req.name):
        return False
    for c in req.constraints:
        lval, lok = resolve_device_target(c.ltarget, dev)
        rval, rok = resolve_device_target(c.rtarget, dev)
        if not check_constraint(c.operand, lval, rval, lok, rok):
            return False
    return True


def device_affinity_score(dev: NodeDeviceResource, req: RequestedDevice) -> Tuple[float, float]:
    """Returns (normalized choice score, sum of matched weights)
    for one group vs one request (device.go:70-95)."""
    if not req.affinities:
        return 0.0, 0.0
    total = 0.0
    choice = 0.0
    matched = 0.0
    for a in req.affinities:
        lval, lok = resolve_device_target(a.ltarget, dev)
        rval, rok = resolve_device_target(a.rtarget, dev)
        total += abs(float(a.weight))
        if check_constraint(a.operand, lval, rval, lok, rok):
            choice += float(a.weight)
            matched += float(a.weight)
    if total > 0:
        choice /= total
    return choice, matched


class DeviceAllocator(DeviceAccounter):
    """Exact instance-level allocator (device.go:13)."""

    def __init__(self, node) -> None:
        super().__init__(node)
        self._groups: Dict[str, NodeDeviceResource] = {
            d.id_string(): d for d in node.node_resources.devices
        }

    def assign(self, req: RequestedDevice) -> Tuple[Optional[AllocatedDeviceResource], float, str]:
        """AssignDevice (device.go:32): returns (offer, matched_weights, err)."""
        if not self.devices:
            return None, 0.0, "no devices available"
        if req.count == 0:
            return None, 0.0, "invalid request of zero devices"

        offer = None
        offer_score = 0.0
        matched_weights = 0.0
        for dev_id, instances in self.devices.items():
            free = [iid for iid, n in instances.items() if n == 0]
            if len(free) < req.count:
                continue
            group = self._groups.get(dev_id)
            if group is None or not node_device_matches(group, req):
                continue
            choice, matched = device_affinity_score(group, req)
            if offer is not None and choice < offer_score:
                continue
            offer_score = choice
            matched_weights = matched
            offer = AllocatedDeviceResource(
                vendor=group.vendor,
                type=group.type,
                name=group.name,
                device_ids=free[: req.count],
            )
        if offer is None:
            return None, 0.0, "no devices match request"
        return offer, matched_weights, ""


def device_planes_for_node(node, proposed_allocs, requests: List[RequestedDevice]):
    """Build (free_counts per request, affinity score) for one node.

    ``free_counts[r]`` = free instances in the *best single matching
    group* (count feasibility plane); affinity score mirrors
    rank.go:549-554: sum of matched weights over all requests divided by
    the total absolute affinity weight.
    """
    alloc = DeviceAllocator(node)
    alloc.add_allocs(proposed_allocs)
    free_counts = []
    total_weight = 0.0
    sum_matched = 0.0
    for req in requests:
        best_free = 0
        best_choice = -math.inf
        best_matched = 0.0
        for a in req.affinities:
            total_weight += abs(float(a.weight))
        for dev_id, instances in alloc.devices.items():
            group = alloc._groups.get(dev_id)
            if group is None or not node_device_matches(group, req):
                continue
            free = sum(1 for n in instances.values() if n == 0)
            choice, matched = device_affinity_score(group, req)
            # prefer higher-affinity groups; among equal, more free
            if (choice, free) > (best_choice, best_free):
                best_choice, best_free, best_matched = choice, free, matched
        free_counts.append(best_free)
        sum_matched += best_matched if best_free > 0 else 0.0
    score = (sum_matched / total_weight) if total_weight > 0 else 0.0
    return free_counts, score, total_weight > 0
