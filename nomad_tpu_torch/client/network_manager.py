"""Bridge-mode allocation networking: per-alloc netns + veth + ports.

Reference behavior: client/allocrunner/networking_bridge_linux.go +
network_hook.go — every bridge-mode allocation gets its own network
namespace joined to a shared client bridge through a veth pair, so two
allocations on one node can bind the SAME container port without
conflict, and the scheduler's host-port assignments (NetworkIndex)
map onto each alloc's namespace IP.

Deviations from the reference, both documented:
- the reference wires port maps with iptables DNAT via CNI; this
  environment has no netfilter NAT, so host-port -> alloc-port
  mappings run through the NATIVE splice(2) relay (native/relay.cc):
  one detached epoll process per allocation moving bytes in kernel
  space, surviving agent restarts the way DNAT rules do (pid persisted
  under the temp dir's nomad-tpu-relays for teardown). A per-connection Python
  relay remains as the fallback when the binary cannot build.
- DNS/config files are inherited from the host (no per-ns resolv.conf)

Capability-gated: ``bridge_supported()`` probes netns/veth privileges
once; clients without them skip the hook (the reference equally
requires CNI plugins + root).
"""

from __future__ import annotations

import functools
import logging
import os
import socket
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

LOG = logging.getLogger(__name__)

DEFAULT_BRIDGE = "nomadtpu0"
DEFAULT_SUBNET_PREFIX = "172.26.64"     # /20 like the reference default
GATEWAY_HOST = 1


def _run(argv: List[str], timeout: float = 15.0) -> subprocess.CompletedProcess:
    return subprocess.run(argv, capture_output=True, timeout=timeout)


@functools.lru_cache(maxsize=1)
def bridge_supported() -> bool:
    """Can this host create netns + veth? (probe once)"""
    # names of this process's own: two processes probing at once (the
    # reference's client among them) must not take each other's netns
    ns = f"nomadtpt-probe-{os.getpid()}"
    veth = f"ntp{os.getpid()}"
    try:
        if _run(["ip", "netns", "add", ns]).returncode != 0:
            return False
        ok = _run(["ip", "link", "add", f"{veth}a", "type", "veth",
                   "peer", "name", f"{veth}b"]).returncode == 0
        _run(["ip", "link", "del", f"{veth}a"])
        return ok
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        try:
            _run(["ip", "netns", "del", ns])
        except (OSError, subprocess.TimeoutExpired):
            pass


class _PortForward:
    """Userspace host-port -> (alloc_ip, port) TCP relay (the DNAT
    deviation). One listener thread; a pump thread pair per conn."""

    def __init__(self, host_port: int, target_ip: str, target_port: int) -> None:
        self.host_port = host_port
        self.target = (target_ip, target_port)
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", self.host_port))
        self._listener.listen(16)
        self._listener.settimeout(0.5)
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"portmap-{self.host_port}",
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(
                target=self._relay, args=(conn,), daemon=True,
            ).start()

    def _relay(self, conn: socket.socket) -> None:
        try:
            upstream = socket.create_connection(self.target, timeout=10)
        except OSError:
            conn.close()
            return

        def pump(src, dst):
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    dst.sendall(data)
            except OSError:
                pass
            finally:
                for s in (src, dst):
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass

        t = threading.Thread(target=pump, args=(conn, upstream), daemon=True)
        t.start()
        pump(upstream, conn)
        t.join(timeout=2)
        for s in (conn, upstream):
            try:
                s.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass


class _UdpForward:
    """Userspace UDP host-port -> (alloc_ip, port) relay (the CNI
    portmap udp rule analog; fallback when the native relay cannot
    build). NAT-style sessions: a datagram from a new client address
    opens a connected socket to the target so replies route back."""

    IDLE_SECS = 120.0

    def __init__(self, host_port: int, target_ip: str, target_port: int) -> None:
        self.host_port = host_port
        self.target = (target_ip, target_port)
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        # client addr -> [session socket, last_active, client addr];
        # _by_sock mirrors it keyed by the session socket so replies
        # avoid an O(sessions) scan per datagram
        self._sessions: Dict[tuple, list] = {}
        self._by_sock: Dict[socket.socket, list] = {}

    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", self.host_port))
        self._sock.settimeout(0.5)
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"udpmap-{self.host_port}")
        self._thread.start()

    def _loop(self) -> None:
        import select
        import time as _time

        while not self._stop.is_set():
            socks = [self._sock] + [e[0] for e in self._sessions.values()]
            try:
                ready, _, _ = select.select(socks, [], [], 0.5)
            except OSError:
                break
            now = _time.monotonic()
            for s in ready:
                if s is self._sock:
                    try:
                        data, addr = self._sock.recvfrom(65536)
                    except OSError:
                        continue
                    entry = self._sessions.get(addr)
                    if entry is None:
                        sess = socket.socket(socket.AF_INET,
                                             socket.SOCK_DGRAM)
                        sess.connect(self.target)
                        sess.setblocking(False)
                        entry = [sess, now, addr]
                        self._sessions[addr] = entry
                        self._by_sock[sess] = entry
                    entry[1] = now
                    try:
                        entry[0].send(data)
                    except OSError:
                        pass
                else:
                    entry = self._by_sock.get(s)
                    if entry is None:
                        continue
                    try:
                        data = s.recv(65536)
                    except OSError:
                        continue
                    entry[1] = now
                    try:
                        self._sock.sendto(data, entry[2])
                    except OSError:
                        pass
            for addr in [a for a, e in self._sessions.items()
                         if now - e[1] > self.IDLE_SECS]:
                entry = self._sessions.pop(addr)
                self._by_sock.pop(entry[0], None)
                try:
                    entry[0].close()
                except OSError:
                    pass

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # snapshot: the loop thread may mutate the dict until it
        # notices the stop flag
        for entry in list(self._sessions.values()):
            try:
                entry[0].close()
            except OSError:
                pass


RELAY_STATE_DIR = os.path.join(tempfile.gettempdir(), "nomad-tpu-relays")


class _NativeRelay:
    """Detached native/relay.cc process carrying every port map of one
    allocation (the DNAT analog: kernel-space splice, survives agent
    restarts; the pid is persisted for teardown)."""

    def __init__(self, alloc_id: str, pid: int, status_path: str) -> None:
        self.alloc_id = alloc_id
        self.pid = pid
        self.status_path = status_path

    def stop(self) -> None:
        import os
        import signal as _signal

        try:
            os.kill(self.pid, _signal.SIGTERM)
        except OSError:
            pass
        try:
            os.unlink(self.status_path)
        except OSError:
            pass

    @classmethod
    def spawn(cls, alloc_id: str,
              mappings: List[Tuple[int, int]], target_ip: str,
              timeout: float = 5.0) -> "_NativeRelay":
        import os
        import time

        from nomad_tpu_torch.drivers.rawexec import executor_path

        # the relay builds with the executor (same Makefile)
        if executor_path() is None:
            raise RuntimeError("native toolchain unavailable")
        binary = os.path.join(
            os.path.dirname(executor_path()), "relay")
        if not os.path.exists(binary):
            raise RuntimeError("native relay binary missing")
        os.makedirs(RELAY_STATE_DIR, exist_ok=True)
        status = os.path.join(RELAY_STATE_DIR, f"{alloc_id}.status")
        try:
            os.unlink(status)
        except OSError:
            pass
        specs = [f"{host}:{target_ip}:{cont}"
                 for host, cont in mappings]
        proc = subprocess.Popen(
            [binary, status] + specs,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        def _abort(msg: str) -> RuntimeError:
            # Kill the spawn before raising: a half-started detached
            # relay would otherwise hold the alloc's host ports so the
            # Python fallback (and any future alloc) could never bind
            # them, and normal destroy() never sees this process.
            try:
                proc.terminate()
            except OSError:
                pass
            try:
                os.unlink(status)
            except OSError:
                pass
            return RuntimeError(msg)

        deadline = time.time() + timeout
        pid = 0
        while time.time() < deadline:
            try:
                with open(status) as f:
                    content = f.read()
            except FileNotFoundError:
                content = ""
            for line in content.splitlines():
                if line.startswith("pid "):
                    pid = int(line.split()[1])
                if line.startswith("error "):
                    raise _abort(f"relay: {line[6:]}")
                if line.startswith("ready "):
                    return cls(alloc_id, pid, status)
            if proc.poll() is not None:
                raise _abort(
                    f"relay exited rc={proc.returncode} before ready")
            time.sleep(0.01)
        raise _abort("relay did not report ready")

    @staticmethod
    def kill_persisted(alloc_id: str) -> None:
        """Teardown after an agent restart: the live process is found
        through the persisted status file, not agent memory."""
        import os
        import signal as _signal

        status = os.path.join(RELAY_STATE_DIR, f"{alloc_id}.status")
        try:
            with open(status) as f:
                for line in f:
                    if line.startswith("pid "):
                        try:
                            os.kill(int(line.split()[1]), _signal.SIGTERM)
                        except OSError:
                            pass
            os.unlink(status)
        except OSError:
            pass


class AllocNetwork:
    """One allocation's namespace + relays (network_hook state)."""

    def __init__(self, alloc_id: str, ns_name: str, ip: str,
                 veth_host: str, forwards: List[_PortForward],
                 gateway: str = "", native_relay=None,
                 port_mappings: Optional[List[Tuple[int, int]]] = None
                 ) -> None:
        self.alloc_id = alloc_id
        self.ns_name = ns_name
        self.ip = ip
        self.veth_host = veth_host
        self.forwards = forwards
        self.native_relay = native_relay
        # kept for the watchdog's respawn (iptables rules can't crash;
        # a relay process can)
        self.port_mappings = list(port_mappings or [])
        # the bridge address: how processes INSIDE the namespace reach
        # host-bound listeners (port relays, other allocs' host ports)
        self.gateway = gateway


class BridgeNetworkManager:
    """Client-wide bridge + per-alloc namespace lifecycle
    (networking_bridge_linux.go bridgeNetworkConfigurator)."""

    #: seconds between relay liveness checks (the "heartbeat" a dead
    #: relay is respawned within)
    WATCHDOG_INTERVAL = 3.0

    def __init__(self, bridge: str = DEFAULT_BRIDGE,
                 subnet_prefix: str = DEFAULT_SUBNET_PREFIX) -> None:
        self.bridge = bridge
        self.subnet_prefix = subnet_prefix
        self._lock = threading.Lock()
        self._used_hosts: set = set()
        self._allocs: Dict[str, AllocNetwork] = {}
        self._bridge_ready = False
        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()

    # -- relay supervision ----------------------------------------------

    def _ensure_watchdog(self) -> None:
        """Supervise native relays: iptables DNAT rules (the reference
        analog) cannot crash, but a relay process can — port maps would
        silently go dead. A dead relay is respawned from the alloc's
        recorded mappings within WATCHDOG_INTERVAL.

        Each watchdog generation carries its OWN stop event: a stopped
        thread keeps its (set) event and exits on its next check, while
        the replacement starts with a fresh event — the stop flag can
        never be cleared out from under a dying loop, so two live loops
        cannot coexist past the ownership check in _watchdog_loop."""
        with self._lock:
            prev = self._watchdog
            if (prev is not None and prev.is_alive()
                    and not self._watchdog_stop.is_set()):
                return
            self._watchdog_stop = stop = threading.Event()
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, args=(stop,), daemon=True,
                name="relay-watchdog")
            self._watchdog.start()

    def stop_watchdog(self) -> None:
        with self._lock:
            self._watchdog_stop.set()

    @staticmethod
    def _relay_alive(pid: int) -> bool:
        # kill(pid, 0) succeeds on zombies (a relay killed while the
        # agent lives is our unreaped child); /proc tells the truth
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().split(")")[1].split()[0] != "Z"
        except OSError:
            return False

    def _watchdog_loop(self, stop: threading.Event) -> None:
        me = threading.current_thread()
        while not stop.wait(self.WATCHDOG_INTERVAL):
            with self._lock:
                # replaced generations stand down: only the CURRENT
                # watchdog holds respawn duty, so a straggling old loop
                # can never double-spawn a relay alongside the new one
                if self._watchdog is not me:
                    return
                nets = [n for n in self._allocs.values()
                        if n.native_relay is not None]
            for net in nets:
                if self._relay_alive(net.native_relay.pid):
                    continue
                with self._lock:
                    # teardown may have raced the check
                    if self._allocs.get(net.alloc_id) is not net:
                        continue
                LOG.warning("alloc %s: native relay pid %d died; "
                            "respawning", net.alloc_id[:8],
                            net.native_relay.pid)
                try:
                    fresh = _NativeRelay.spawn(
                        net.alloc_id, net.port_mappings, net.ip)
                except Exception as e:          # noqa: BLE001
                    LOG.warning("alloc %s: relay respawn failed: %s",
                                net.alloc_id[:8], e)
                    continue
                with self._lock:
                    if (self._allocs.get(net.alloc_id) is net
                            and self._watchdog is me):
                        net.native_relay = fresh
                        fresh = None
                if fresh is not None:
                    # destroy() completed (or this generation was
                    # replaced) while we were spawning: the fresh relay
                    # would leak and hold the host ports forever
                    fresh.stop()

    # -- bridge ----------------------------------------------------------

    def _ensure_bridge(self) -> None:
        if self._bridge_ready:
            return
        if _run(["ip", "link", "show", self.bridge]).returncode != 0:
            out = _run(["ip", "link", "add", "name", self.bridge,
                        "type", "bridge"])
            if out.returncode != 0:
                raise RuntimeError(
                    f"bridge create: {out.stderr.decode(errors='replace')}")
            _run(["ip", "addr", "add",
                  f"{self.subnet_prefix}.{GATEWAY_HOST}/20",
                  "dev", self.bridge])
        _run(["ip", "link", "set", self.bridge, "up"])
        self._adopt_existing()
        self._bridge_ready = True

    def _adopt_existing(self) -> None:
        """Mark IPs held by pre-existing nomad netns as used.

        Namespaces outlive the agent process by design (tasks keep
        running across restarts for reattach, like the reference's
        executor); a fresh in-memory allocator would hand their IPs to
        new allocations and the shared bridge would route new traffic
        into the old namespace. The reference gets this from CNI's
        host-local IPAM lease files; here the running namespaces ARE
        the lease state."""
        out = _run(["ip", "netns", "list"])
        if out.returncode != 0:
            return
        for line in out.stdout.decode(errors="replace").splitlines():
            name = line.split()[0] if line.split() else ""
            if not name.startswith("nomad-"):
                continue
            addrs = _run(["ip", "netns", "exec", name,
                          "ip", "-4", "-o", "addr", "show"])
            for al in addrs.stdout.decode(errors="replace").splitlines():
                if "inet " not in al:
                    continue
                ip = al.split("inet ", 1)[1].split("/", 1)[0]
                if ip.startswith(self.subnet_prefix + "."):
                    try:
                        with self._lock:
                            self._used_hosts.add(int(ip.rsplit(".", 1)[1]))
                    except ValueError:
                        pass

    def _alloc_ip(self) -> str:
        # hosts .2..254 in the third+fourth octet space; _adopt_existing
        # seeds the set with IPs still held by namespaces from previous
        # agent processes
        with self._lock:
            for host in range(2, 255):
                if host not in self._used_hosts:
                    self._used_hosts.add(host)
                    return f"{self.subnet_prefix}.{host}"
        raise RuntimeError("bridge subnet exhausted")

    # -- alloc lifecycle -------------------------------------------------

    def create(self, alloc_id: str,
               port_mappings: List[Tuple[int, int]]) -> AllocNetwork:
        """netns + veth + relays. ``port_mappings`` is
        [(host_port, container_port)] from the scheduler's assignment
        (AllocatedSharedResources.ports)."""
        self._ensure_bridge()
        short = alloc_id.replace("-", "")[:10]
        ns = f"nomad-{short}"
        veth_h, veth_c = f"nv{short[:8]}h", f"nv{short[:8]}c"
        ip = self._alloc_ip()

        steps = [
            ["ip", "netns", "add", ns],
            ["ip", "link", "add", veth_h, "type", "veth",
             "peer", "name", veth_c],
            ["ip", "link", "set", veth_c, "netns", ns],
            ["ip", "link", "set", veth_h, "master", self.bridge],
            ["ip", "link", "set", veth_h, "up"],
            ["ip", "netns", "exec", ns, "ip", "addr", "add",
             f"{ip}/20", "dev", veth_c],
            ["ip", "netns", "exec", ns, "ip", "link", "set", veth_c, "up"],
            ["ip", "netns", "exec", ns, "ip", "link", "set", "lo", "up"],
            ["ip", "netns", "exec", ns, "ip", "route", "add", "default",
             "via", f"{self.subnet_prefix}.{GATEWAY_HOST}"],
        ]
        forwards: List[_PortForward] = []
        native_relay = None
        try:
            for argv in steps:
                out = _run(argv)
                if out.returncode != 0:
                    raise RuntimeError(
                        f"{' '.join(argv)}: "
                        f"{out.stderr.decode(errors='replace').strip()}")
            if port_mappings:
                try:
                    native_relay = _NativeRelay.spawn(
                        alloc_id, port_mappings, ip)
                except Exception as e:          # noqa: BLE001
                    LOG.warning("native relay unavailable (%s); using "
                                "in-process port relays", e)
                    for host_port, container_port in port_mappings:
                        # both protocols per mapping (CNI portmap
                        # programs tcp AND udp DNAT rules)
                        fwd = _PortForward(host_port, ip, container_port)
                        fwd.start()
                        forwards.append(fwd)
                        ufwd = _UdpForward(host_port, ip, container_port)
                        ufwd.start()
                        forwards.append(ufwd)
        except Exception:
            self._teardown(ns, veth_h, ip, forwards, native_relay)
            raise
        net = AllocNetwork(alloc_id, ns, ip, veth_h, forwards,
                           gateway=f"{self.subnet_prefix}.{GATEWAY_HOST}",
                           native_relay=native_relay,
                           port_mappings=port_mappings)
        with self._lock:
            self._allocs[alloc_id] = net
        if native_relay is not None:
            self._ensure_watchdog()
        return net

    def destroy(self, alloc_id: str) -> None:
        with self._lock:
            net = self._allocs.pop(alloc_id, None)
            # stop the watchdog with the last relay-bearing network:
            # without this the daemon thread polls every 3s for the
            # life of the process after all alloc networks are gone
            if not any(n.native_relay is not None
                       for n in self._allocs.values()):
                self._watchdog_stop.set()
        if net is None:
            # an alloc from a previous agent process may still have a
            # live detached relay; the persisted pid file finds it
            _NativeRelay.kill_persisted(alloc_id)
            return
        self._teardown(net.ns_name, net.veth_host, net.ip, net.forwards,
                       net.native_relay)

    def _teardown(self, ns: str, veth_h: str, ip: str,
                  forwards: List[_PortForward], native_relay=None) -> None:
        for fwd in forwards:
            fwd.stop()
        if native_relay is not None:
            native_relay.stop()
        _run(["ip", "netns", "del", ns])
        _run(["ip", "link", "del", veth_h])
        try:
            host = int(ip.rsplit(".", 1)[1])
            with self._lock:
                self._used_hosts.discard(host)
        except (ValueError, IndexError):
            pass

    def network_of(self, alloc_id: str) -> Optional[AllocNetwork]:
        with self._lock:
            return self._allocs.get(alloc_id)
