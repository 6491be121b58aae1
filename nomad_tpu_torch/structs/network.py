"""Network resources and per-node port/bandwidth accounting.

Reference behavior: nomad/structs/network.go -- ``NetworkIndex`` (:39),
``SetNode`` (:176), ``AddAllocs`` (:242), ``AddReserved`` (:298),
``AssignPorts`` (:427), ``AssignNetwork`` (:517), dynamic port range
20000..32000 (:13-19), ``Bitmap`` (nomad/structs/bitmap.go).

TPU-first design note: the port bitmap is a numpy uint64 array so the
cluster-wide "used ports" plane stacks into a ``[n_nodes, 1024]`` u64 tensor
that the device kernel can gather against for reserved-port feasibility
(ragged per-port data in a fixed-width encoding); *assignment* of specific
dynamic ports stays host-side and only runs for the selected node.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MAX_VALID_PORT = 65536
DEFAULT_MIN_DYNAMIC_PORT = 20000
DEFAULT_MAX_DYNAMIC_PORT = 32000

_WORDS = MAX_VALID_PORT // 64  # 1024 uint64 words cover the port space


@dataclass
class Port:
    """A labeled port ask/offer (reference structs.go Port)."""

    label: str = ""
    value: int = 0           # 0 for dynamic asks; assigned value in offers
    to: int = 0              # mapped-to port inside the task namespace
    host_network: str = "default"

    def copy(self) -> "Port":
        return dataclasses.replace(self)


@dataclass
class NetworkResource:
    """A network ask or offer (reference structs.go NetworkResource)."""

    mode: str = "host"
    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: List[Port] = field(default_factory=list)
    dynamic_ports: List[Port] = field(default_factory=list)

    def copy(self) -> "NetworkResource":
        return dataclasses.replace(
            self,
            reserved_ports=[p.copy() for p in self.reserved_ports],
            dynamic_ports=[p.copy() for p in self.dynamic_ports],
        )

    def port_for_label(self, label: str) -> Optional[int]:
        for p in list(self.reserved_ports) + list(self.dynamic_ports):
            if p.label == label:
                return p.value
        return None


class PortBitmap:
    """Fixed 65536-bit port bitmap backed by numpy uint64 words.

    Reference: nomad/structs/bitmap.go. The numpy representation is the
    tensorization seam: ``PortBitmap.words`` rows stack into the cluster
    port-plane consumed by the JAX kernel.
    """

    __slots__ = ("words",)

    def __init__(self, words: Optional[np.ndarray] = None) -> None:
        self.words = words if words is not None else np.zeros(_WORDS, dtype=np.uint64)

    def set(self, port: int) -> None:
        self.words[port >> 6] |= np.uint64(1 << (port & 63))

    def clear(self, port: int) -> None:
        self.words[port >> 6] &= ~np.uint64(1 << (port & 63))

    def check(self, port: int) -> bool:
        return bool(self.words[port >> 6] & np.uint64(1 << (port & 63)))

    def copy(self) -> "PortBitmap":
        return PortBitmap(self.words.copy())

    def _bits_in_range(self, lo: int, hi: int) -> np.ndarray:
        """Unpack only the words covering [lo, hi] (not the full 64Ki space)."""
        wlo, whi = lo >> 6, (hi >> 6) + 1
        bits = np.unpackbits(self.words[wlo:whi].view(np.uint8), bitorder="little")
        base = wlo << 6
        return bits[lo - base : hi + 1 - base]

    def indexes_in_range(self, set_: bool, lo: int, hi: int, limit: int = 0) -> List[int]:
        """Ports in [lo, hi] whose bit equals ``set_`` (bitmap.go
        IndexesInRange). ``limit`` > 0 stops after that many matches."""
        bits = self._bits_in_range(lo, hi)
        sel = np.nonzero(bits == (1 if set_ else 0))[0]
        if limit > 0:
            sel = sel[:limit]
        return (sel + lo).tolist()

    def free_count_in_range(self, lo: int, hi: int) -> int:
        return int((self._bits_in_range(lo, hi) == 0).sum())


class NetworkIndex:
    """Per-node port and bandwidth accounting (network.go:39).

    Tracks used ports per IP and used bandwidth per device; offers
    reserved-port collision detection and dynamic-port assignment.
    """

    def __init__(self) -> None:
        self.avail_networks: List[NetworkResource] = []
        self.avail_addresses: Dict[str, List[Tuple[str, str]]] = {}  # host_network -> [(iface, ip)]
        self.avail_bandwidth: Dict[str, int] = {}
        self.used_ports: Dict[str, PortBitmap] = {}
        self.used_bandwidth: Dict[str, int] = {}
        self.min_dynamic_port = DEFAULT_MIN_DYNAMIC_PORT
        self.max_dynamic_port = DEFAULT_MAX_DYNAMIC_PORT
        self._rng = None

    def seed(self, seed: int) -> None:
        """Enable stochastic dynamic-port selection (network.go:598),
        deterministically per seed."""
        import random

        self._rng = random.Random(seed)

    # -- setup ------------------------------------------------------------

    def _used_for(self, ip: str) -> PortBitmap:
        bm = self.used_ports.get(ip)
        if bm is None:
            bm = PortBitmap()
            self.used_ports[ip] = bm
        return bm

    def set_node(self, node) -> Tuple[bool, str]:
        """Index a node's networks + agent-reserved ports (network.go:176)."""
        collide, reason = False, ""
        for n in node.node_resources.networks:
            if n.device:
                self.avail_networks.append(n)
                self.avail_bandwidth[n.device] = n.mbits
                ip = n.ip or "0.0.0.0"
                self.avail_addresses.setdefault("default", []).append((n.device, ip))

        # Node-reserved host ports collide if double-reserved.
        reserved = getattr(node.reserved_resources, "networks_ports", [])
        for port in reserved:
            if port < 0 or port >= MAX_VALID_PORT:
                return True, f"invalid port {port}"
            for ip in self._all_ips():
                used = self._used_for(ip)
                if used.check(port):
                    collide, reason = True, f"port {port} already reserved"
                else:
                    used.set(port)
        if node.node_resources.min_dynamic_port:
            self.min_dynamic_port = node.node_resources.min_dynamic_port
        if node.node_resources.max_dynamic_port:
            self.max_dynamic_port = node.node_resources.max_dynamic_port
        return collide, reason

    def _all_ips(self) -> List[str]:
        ips = [ip for addrs in self.avail_addresses.values() for _, ip in addrs]
        return ips or ["0.0.0.0"]

    def add_allocs(self, allocs) -> Tuple[bool, str]:
        """Index ports used by existing allocations (network.go:242)."""
        collide, reason = False, ""
        for alloc in allocs:
            if not alloc.terminal_status():
                ar = alloc.allocated_resources
                if ar is None:
                    continue
                for tr in ar.tasks.values():
                    for net in tr.networks:
                        c, r = self.add_reserved(net)
                        if c:
                            collide, reason = True, r
                # Group-shared ports are recorded against the node's primary
                # IP (single-address model; per-host-network routing is a
                # representational extension, not implemented).
                for port in ar.shared.ports:
                    if port.value < 0 or port.value >= MAX_VALID_PORT:
                        collide, reason = True, f"invalid port {port.value}"
                        continue
                    used = self._used_for(self._all_ips()[0])
                    if used.check(port.value):
                        collide, reason = True, f"port {port.value} already in use"
                    else:
                        used.set(port.value)
        return collide, reason

    def add_reserved(self, n: NetworkResource) -> Tuple[bool, str]:
        """Mark an offer's ports as used (network.go:298)."""
        collide, reason = False, ""
        ip = n.ip or self._all_ips()[0]
        used = self._used_for(ip)
        for port in list(n.reserved_ports) + list(n.dynamic_ports):
            if port.value >= MAX_VALID_PORT or port.value < 0:
                return True, f"invalid port {port.value}"
            if used.check(port.value):
                collide, reason = True, f"port {port.value} already in use"
            else:
                used.set(port.value)
        self.used_bandwidth[n.device] = self.used_bandwidth.get(n.device, 0) + n.mbits
        return collide, reason

    def add_reserved_ports(self, ports: List[Port]) -> Tuple[bool, str]:
        """Mark group-level allocated ports used (network.go:323)."""
        collide, reason = False, ""
        for port in ports:
            if port.value < 0 or port.value >= MAX_VALID_PORT:
                collide, reason = True, f"invalid port {port.value}"
                continue
            used = self._used_for(self._all_ips()[0])
            if used.check(port.value):
                collide, reason = True, f"port {port.value} already in use"
            else:
                used.set(port.value)
        return collide, reason

    # -- queries ----------------------------------------------------------

    def overcommitted(self) -> bool:
        """Bandwidth overcommit check (network.go:163)."""
        for device, used in self.used_bandwidth.items():
            avail = self.avail_bandwidth.get(device, 0)
            if used > avail:
                return True
        return False

    def _assign_dynamic(self, used: PortBitmap, reserved_asks: List[Port], count: int) -> Optional[List[int]]:
        """Dynamic port selection: seeded-stochastic, then precise.

        The reference tries stochastic then precise selection
        (network.go:598,640). The stochastic pass matters under
        concurrency: schedulers picking ports for the same node from
        the same snapshot must decorrelate, or every plan but the first
        is rejected by the applier's collision re-check. ``seed()``
        (per eval, like shuffleNodes util.go:464) keeps plans
        reproducible; unseeded indexes use the precise path only.
        """
        if count == 0:
            return []
        taken = {p.value for p in reserved_asks}
        if self._rng is not None:
            span = self.max_dynamic_port - self.min_dynamic_port + 1
            picked: List[int] = []
            for _ in range(20 * count + 20):
                if len(picked) == count:
                    break
                port = self.min_dynamic_port + self._rng.randrange(span)
                if port in taken or port in picked or used.check(port):
                    continue
                picked.append(port)
            if len(picked) == count:
                return picked
        out: List[int] = []
        # Over-fetch by len(taken) so reserved asks in the range can't starve us.
        candidates = used.indexes_in_range(
            False, self.min_dynamic_port, self.max_dynamic_port,
            limit=count + len(taken),
        )
        for port in candidates:
            if port in taken:
                continue
            out.append(port)
            if len(out) == count:
                return out
        return None

    def assign_ports(self, ask: NetworkResource) -> Tuple[Optional[List[Port]], str]:
        """Assign group-level ports (network.go:427). Returns (offer, err)."""
        offer: List[Port] = []
        ip = self._all_ips()[0]
        used = self._used_for(ip)
        reserved_asks = list(ask.reserved_ports)

        for port in ask.reserved_ports:
            if port.value < 0 or port.value >= MAX_VALID_PORT:
                return None, f"invalid port {port.value} (out of range)"
            if used.check(port.value):
                return None, f"reserved port collision {port.label}={port.value}"
            offer.append(Port(label=port.label, value=port.value,
                              to=port.to, host_network=port.host_network))

        dyn = self._assign_dynamic(used, reserved_asks, len(ask.dynamic_ports))
        if dyn is None:
            return None, "dynamic port selection failed"
        for port, value in zip(ask.dynamic_ports, dyn):
            to = port.to if port.to != -1 else value
            offer.append(Port(label=port.label, value=value, to=to,
                              host_network=port.host_network))
        return offer, ""

    def assign_network(self, ask: NetworkResource) -> Tuple[Optional[NetworkResource], str]:
        """Assign a legacy task-level network (network.go:517)."""
        err = "no networks available"
        for n in self.avail_networks:
            ip = n.ip or "0.0.0.0"
            avail_bw = self.avail_bandwidth.get(n.device, 0)
            used_bw = self.used_bandwidth.get(n.device, 0)
            if used_bw + ask.mbits > avail_bw:
                err = "bandwidth exceeded"
                continue
            used = self._used_for(ip)
            collision = False
            for port in ask.reserved_ports:
                if port.value < 0 or port.value >= MAX_VALID_PORT:
                    return None, f"invalid port {port.value} (out of range)"
                if used.check(port.value):
                    err = f"reserved port collision {port.label}={port.value}"
                    collision = True
                    break
            if collision:
                continue
            dyn = self._assign_dynamic(used, list(ask.reserved_ports), len(ask.dynamic_ports))
            if dyn is None:
                err = "dynamic port selection failed"
                continue
            offer = NetworkResource(
                mode=ask.mode, device=n.device, ip=ip, mbits=ask.mbits,
                reserved_ports=[p.copy() for p in ask.reserved_ports],
                dynamic_ports=[
                    Port(label=p.label, value=v, to=(p.to if p.to != -1 else v),
                         host_network=p.host_network)
                    for p, v in zip(ask.dynamic_ports, dyn)
                ],
            )
            return offer, ""
        return None, err

    # -- tensorization seam ----------------------------------------------

    def port_words(self) -> np.ndarray:
        """OR of all per-IP bitmaps -> one u64[1024] row for the node plane."""
        acc = np.zeros(_WORDS, dtype=np.uint64)
        for bm in self.used_ports.values():
            acc |= bm.words
        return acc

    def free_dynamic_count(self) -> int:
        bm = PortBitmap(self.port_words())
        return bm.free_count_in_range(self.min_dynamic_port, self.max_dynamic_port)
