"""The port's server gossip membership, on the CPU.

Every scenario of ``tests/test_membership.py`` runs on the port's
``server/membership`` (a copy of the reference's; nomad/serf.go +
hashicorp/serf SWIM) at the reference test's shrunk probe intervals:
liveness-probed member status, failure detection, graceful leave,
refutation, join-by-DNS, HMAC-keyed gossip, join-address parsing, and
the leader's membership-driven raft peer add/remove
(leader.go:1182-1345) between three HA agents of the port, each placing
on ``device="cpu"``."""

import socket
import time

import pytest

from nomad_tpu_torch.server.membership import (
    ALIVE,
    FAILED,
    LEFT,
    MEMBER_FAILED,
    MEMBER_JOIN,
    MEMBER_LEAVE,
    Membership,
    expand_join_addrs,
)


def _wait(fn, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if fn():
                return True
        except Exception:                        # noqa: BLE001
            pass
        time.sleep(0.05)
    return False


def _mk(name, **kw):
    kw.setdefault("probe_interval", 0.1)
    kw.setdefault("probe_timeout", 0.25)
    kw.setdefault("suspect_timeout", 0.5)
    m = Membership(name=name, **kw)
    m.start()
    return m


@pytest.fixture()
def trio():
    ms = [_mk(f"srv-{i}", tags={"idx": str(i)}) for i in range(3)]
    seed = [(ms[0].host, ms[0].port)]
    for m in ms[1:]:
        m.join(seed)
    try:
        yield ms
    finally:
        for m in ms:
            m.shutdown(leave=False)


class TestMembership:
    def test_join_converges_to_full_view(self, trio):
        for m in trio:
            assert _wait(lambda m=m: len(m.members()) == 3), \
                f"{m.name} sees {m.members()}"
            assert all(r["Status"] == ALIVE for r in m.members())
        # tags gossiped through the seed, not just direct contacts
        view = {r["Name"]: r for r in trio[2].members()}
        assert view["srv-1"]["Tags"]["idx"] == "1"

    def test_member_join_events_fire(self):
        events = []
        a = _mk("a", on_event=lambda k, m: events.append((k, m["Name"])))
        b = _mk("b")
        try:
            b.join([(a.host, a.port)])
            assert _wait(lambda: (MEMBER_JOIN, "b") in events)
        finally:
            a.shutdown(leave=False)
            b.shutdown(leave=False)

    def test_crashed_member_detected_as_failed(self, trio):
        events = []
        trio[0].on_event(lambda k, m: events.append((k, m["Name"])))
        for m in trio:
            assert _wait(lambda m=m: len(m.members()) == 3)
        trio[2]._abort()   # crash: no leave message
        assert _wait(
            lambda: trio[0].member_status("srv-2") == FAILED, timeout=15)
        assert (MEMBER_FAILED, "srv-2") in events
        # dissemination: the non-probing observer converges too
        assert _wait(
            lambda: trio[1].member_status("srv-2") == FAILED, timeout=15)

    def test_graceful_leave_is_not_a_failure(self, trio):
        events = []
        trio[0].on_event(lambda k, m: events.append((k, m["Name"])))
        for m in trio:
            assert _wait(lambda m=m: len(m.members()) == 3)
        trio[2].shutdown(leave=True)
        assert _wait(lambda: trio[0].member_status("srv-2") == LEFT,
                     timeout=15)
        assert (MEMBER_LEAVE, "srv-2") in events
        assert (MEMBER_FAILED, "srv-2") not in events

    def test_false_suspicion_is_refuted(self, trio):
        for m in trio:
            assert _wait(lambda m=m: len(m.members()) == 3)
        # inject a rumor: srv-0 gossips that srv-2 is suspect at its
        # current incarnation; srv-2 must bump + re-assert aliveness
        with trio[0]._lock:
            target = trio[0]._members["srv-2"]
            target.status = "suspect"
            trio[0]._suspect_since["srv-2"] = time.monotonic()
        assert _wait(
            lambda: trio[0].member_status("srv-2") == ALIVE, timeout=15), \
            trio[0].members()

    def test_expand_join_addrs_resolves_dns(self):
        out = expand_join_addrs(["localhost:4649"])
        assert ("127.0.0.1", 4649) in out
        # port defaulting
        out = expand_join_addrs(["127.0.0.1"], default_port=4648)
        assert ("127.0.0.1", 4648) in out
        # unresolvable names are skipped, not fatal
        assert expand_join_addrs(["no-such-host.invalid:1"]) == []


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class TestAgentMembership:
    """The serf.go flow end-to-end: HA agents discover each other via
    gossip, `server members` reflects liveness, and the leader prunes
    a crashed server's raft peer without operator action."""

    @pytest.fixture()
    def ha_trio(self):
        from nomad_tpu_torch.api.agent import Agent, AgentConfig

        ports = _free_ports(3)
        peers = [f"127.0.0.1:{p}" for p in ports]
        agents = []
        try:
            for i in range(3):
                a = Agent(AgentConfig(
                    device="cpu", name=f"srv-{i}", num_schedulers=1,
                    raft_port=ports[i], raft_peers=peers,
                    serf_probe_interval=0.1, serf_suspect_timeout=0.5,
                ))
                a.start()
                agents.append(a)
                if i > 0:
                    # join the first agent's membership endpoint
                    a._serf.join([(agents[0]._serf.host,
                                   agents[0]._serf.port)])
            assert _wait(
                lambda: any(x.server.is_leader() for x in agents),
                timeout=30)
            yield agents
        finally:
            for a in agents:
                try:
                    a.shutdown()
                except Exception:                # noqa: BLE001
                    pass

    def test_members_reflect_gossip_and_leader_flag(self, ha_trio):
        for a in ha_trio:
            assert _wait(lambda a=a: len(a.members()) == 3, timeout=15), \
                a.members()
        # the Leader flag rides gossip AFTER the election settles:
        # asserting it at the instant the member count converges raced
        # under suite CPU contention — wait for the flag like the count
        assert _wait(
            lambda: sum(1 for m in ha_trio[1].members()
                        if m.get("Leader")) == 1,
            timeout=15), ha_trio[1].members()

    def test_crashed_server_reaped_from_raft_peers(self, ha_trio):
        for a in ha_trio:
            assert _wait(lambda a=a: len(a.members()) == 3, timeout=15)
        leader = next(a for a in ha_trio if a.server.is_leader())
        victim = next(a for a in ha_trio if a is not leader)
        victim_raft = victim.server.raft.id
        victim_name = victim.config.name
        # crash: kill membership without leave, then the server itself
        victim._serf._abort()
        victim.server.shutdown()
        # the leader's failure detector marks it failed...
        assert _wait(
            lambda: leader._serf.member_status(victim_name) == FAILED,
            timeout=20), leader.members()
        # ...and membership-driven reconcile prunes the raft peer
        assert _wait(
            lambda: victim_raft not in leader.server.raft.peers,
            timeout=20), leader.server.raft.peers
        # the cluster still has a functioning leader
        assert _wait(lambda: any(
            a is not victim and a.server.is_leader() for a in ha_trio))


class TestGossipAuth:
    """HMAC-authenticated gossip (agent `encrypt` config; serf keyring
    analog). Closes the forged member-leave takedown: without a key,
    one spoofed UDP datagram removed a live server from the cluster
    view (and, via reconcile, the raft voter set)."""

    def test_keyed_cluster_converges(self):
        a = _mk("auth-a", encrypt="cluster-secret")
        b = _mk("auth-b", encrypt="cluster-secret")
        try:
            b.join([(a.host, a.port)])
            assert _wait(lambda: a.member_status("auth-b") == ALIVE)
            assert _wait(lambda: b.member_status("auth-a") == ALIVE)
        finally:
            a.shutdown(leave=False)
            b.shutdown(leave=False)

    def test_forged_leave_rejected_without_key(self):
        """An attacker on the segment (no key) cannot make a keyed
        member believe its peer left."""
        import json as _json

        a = _mk("auth-a", encrypt="cluster-secret")
        b = _mk("auth-b", encrypt="cluster-secret")
        try:
            b.join([(a.host, a.port)])
            assert _wait(lambda: a.member_status("auth-b") == ALIVE)
            # forge an unsigned leave claiming to be b
            forged = _json.dumps({
                "t": "leave", "from": "auth-b", "region": a.region,
                "mem": [["auth-b", b.host, b.port, 1 << 31, LEFT, {}]],
            }).encode()
            attacker = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            before = a.rx_rejected
            for _ in range(3):
                attacker.sendto(forged, (a.host, a.port))
            attacker.close()
            assert _wait(lambda: a.rx_rejected >= before + 3)
            # b is still alive in a's view: the takedown failed
            assert a.member_status("auth-b") == ALIVE
        finally:
            a.shutdown(leave=False)
            b.shutdown(leave=False)

    def test_wrong_key_rejected(self):
        a = _mk("auth-a", encrypt="right-key")
        c = _mk("auth-c", encrypt="wrong-key")
        try:
            c.join([(a.host, a.port)])
            time.sleep(0.5)
            assert a.member_status("auth-c") is None
            assert a.rx_rejected > 0
        finally:
            a.shutdown(leave=False)
            c.shutdown(leave=False)

    def test_unkeyed_cluster_still_accepts_plain(self):
        a = _mk("plain-a")
        b = _mk("plain-b")
        try:
            b.join([(a.host, a.port)])
            assert _wait(lambda: a.member_status("plain-b") == ALIVE)
            assert a.rx_rejected == 0
        finally:
            a.shutdown(leave=False)
            b.shutdown(leave=False)


class TestJoinAddrParsing:
    """expand_join_addrs IPv6 handling: bracketed [addr]:port, bare
    IPv6 literals, and AF_INET-restricted resolution (the membership
    socket is IPv4; AAAA records would probe into a black hole)."""

    def test_parse_entry_shapes(self):
        from nomad_tpu_torch.server.membership import parse_join_entry

        assert parse_join_entry("10.0.0.1:4700") == ("10.0.0.1", 4700)
        assert parse_join_entry("10.0.0.1") == ("10.0.0.1", 4648)
        assert parse_join_entry("srv.example:9000") == ("srv.example", 9000)
        assert parse_join_entry("[::1]:4700") == ("::1", 4700)
        assert parse_join_entry("[fe80::1]") == ("fe80::1", 4648)
        # bare IPv6 literal: NOT split at the last colon
        assert parse_join_entry("fe80::1") == ("fe80::1", 4648)
        assert parse_join_entry("2001:db8::2:1") == ("2001:db8::2:1", 4648)

    def test_ipv4_entries_resolve(self):
        out = expand_join_addrs(["127.0.0.1:4701", "127.0.0.1"])
        assert ("127.0.0.1", 4701) in out
        assert ("127.0.0.1", 4648) in out

    def test_ipv6_literal_skipped_on_ipv4_socket(self):
        # an AF_INET lookup cannot yield a dialable target for ::1 —
        # the entry is skipped with a warning, not mis-resolved
        out = expand_join_addrs(["[::1]:4700", "fe80::1"])
        assert out == []

    def test_ipv6_family_opt_in(self):
        out = expand_join_addrs(["[::1]:4700"], family=socket.AF_INET6)
        assert ("::1", 4700) in [a[:2] for a in out]
