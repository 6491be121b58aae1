"""Shared fixture of the port's client tests.

The client side keeps the reference's bridge ``nomadtpu0`` and its
subnet ``172.26.64.0/20`` for bridge-mode allocations. Both packages'
tests run side by side, and two clients that share a bridge hand out
the same addresses from it. A test module that imports ``port_bridge``
gives the port's bridge-mode allocations a bridge and a /20 of their
own.
"""

import pytest

#: the port's bridge in its tests, beside the reference's ``nomadtpu0``
#: on 172.26.64.0/20
PORT_BRIDGE = ("nomadtpt0", "172.26.80")


@pytest.fixture(scope="module", autouse=True)
def port_bridge():
    from nomad_tpu_torch.client.network_manager import BridgeNetworkManager

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BridgeNetworkManager.__init__, "__defaults__",
                   PORT_BRIDGE)
        yield PORT_BRIDGE


def processes_with(text: str) -> list:
    """Pids of the processes whose command line holds ``text`` (an alloc
    id names its executor's and its log collectors' paths)."""
    import os

    pids = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if text in cmd:
            pids.append(int(pid))
    return pids
