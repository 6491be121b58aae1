"""Every scenario of ``tests/test_drivers.py``, on the port's modules:
servers and agents place on ``device="cpu"``, and the port's
bridge-mode allocations take a bridge of their own (``_torch_client``).

java/qemu/docker driver tests.

Modeled on reference drivers/java/driver_test.go,
drivers/qemu/driver_test.go, drivers/docker/driver_test.go -- command
construction, config validation, and fingerprint gating (none of the
three binaries exist in this image, so fingerprints must come back
undetected and the catalog must still register the drivers).
"""

import pytest

from nomad_tpu_torch import structs
from nomad_tpu_torch.client.fingerprint import fingerprint_node
from nomad_tpu_torch.drivers import builtin_drivers
from nomad_tpu_torch.drivers.docker import DockerDriver, _container_name
from nomad_tpu_torch.drivers.java import JavaDriver
from nomad_tpu_torch.drivers.qemu import QemuDriver
from nomad_tpu_torch.plugins.drivers import HEALTH_UNDETECTED, TaskConfig
from _torch_client import port_bridge  # noqa: F401


def cfg(driver_config, **kw):
    return TaskConfig(id="t1", name="web", alloc_id="a1-xyz",
                      driver_config=driver_config,
                      resources=kw.pop("resources", structs.Resources()),
                      **kw)


class TestCatalog:
    def test_all_six_registered(self):
        drivers = builtin_drivers()
        assert set(drivers) == {"mock_driver", "raw_exec", "exec",
                                "java", "qemu", "docker"}

    def test_fingerprint_gating_in_node(self):
        node = fingerprint_node("n1", drivers=builtin_drivers())
        # binaries absent in this image -> undetected, never placed on
        assert not node.drivers["java"].detected
        assert not node.drivers["qemu"].detected
        assert not node.drivers["docker"].detected
        assert node.drivers["raw_exec"].detected


class TestJava:
    def test_fingerprint_gated(self):
        assert JavaDriver().fingerprint().health == HEALTH_UNDETECTED

    def test_jar_command(self):
        argv = JavaDriver()._command(cfg({
            "jar_path": "/opt/app.jar",
            "jvm_options": ["-Xmx512m"],
            "args": ["serve"],
        }))
        assert argv == ["java", "-Xmx512m", "-jar", "/opt/app.jar", "serve"]

    def test_class_command(self):
        argv = JavaDriver()._command(cfg({
            "class": "com.example.Main", "class_path": "/opt/lib",
        }))
        assert argv == ["java", "-cp", "/opt/lib", "com.example.Main"]

    def test_requires_jar_or_class(self):
        with pytest.raises(ValueError):
            JavaDriver()._command(cfg({}))


class TestQemu:
    def test_fingerprint_gated(self):
        assert QemuDriver().fingerprint().health == HEALTH_UNDETECTED

    def test_command(self):
        res = structs.Resources(memory_mb=1024)
        argv = QemuDriver()._command(cfg({"image_path": "/img/linux.img"},
                                         resources=res))
        assert argv[0] == "qemu-system-x86_64"
        assert "-nographic" in argv
        assert "file=/img/linux.img" in argv
        assert "1024M" in argv

    def test_port_forwards(self):
        res = structs.Resources(
            memory_mb=512,
            networks=[structs.NetworkResource(
                reserved_ports=[structs.Port(label="ssh", value=2222)],
            )],
        )
        argv = QemuDriver()._command(cfg({
            "image_path": "/img/linux.img",
            "port_map": {"ssh": 22},
        }, resources=res))
        netdev = argv[argv.index("-netdev") + 1]
        assert "hostfwd=tcp::2222-:22" in netdev

    def test_requires_image(self):
        with pytest.raises(ValueError):
            QemuDriver()._command(cfg({}))


class TestDocker:
    def test_fingerprint_gated(self):
        assert DockerDriver().fingerprint().health == HEALTH_UNDETECTED

    def test_command(self):
        res = structs.Resources(cpu=500, memory_mb=256)
        argv = DockerDriver()._command(cfg(
            {"image": "redis:7", "command": "redis-server",
             "args": ["--appendonly", "yes"]},
            env={"FOO": "bar"}, resources=res,
        ))
        assert argv[:3] == ["docker", "run", "--rm"]
        assert "--memory" in argv and "256m" in argv
        assert "--cpu-shares" in argv and "500" in argv
        assert "-e" in argv and "FOO=bar" in argv
        assert argv[argv.index("redis:7"):] == \
            ["redis:7", "redis-server", "--appendonly", "yes"]

    def test_port_publish(self):
        res = structs.Resources(networks=[structs.NetworkResource(
            dynamic_ports=[structs.Port(label="http", value=20001, to=8080)],
        )])
        argv = DockerDriver()._command(cfg(
            {"image": "nginx", "ports": ["http"]}, resources=res,
        ))
        assert "-p" in argv
        assert "20001:8080" in argv

    def test_container_name_stable(self):
        c = cfg({"image": "nginx"})
        assert _container_name(c) == "nomad-web-a1-xyz"[:len(_container_name(c))]
        assert _container_name(c).startswith("nomad-web-")

    def test_requires_image(self):
        with pytest.raises(ValueError):
            DockerDriver()._command(cfg({}))


class TestDockerVolumesGate:
    """Host bind mounts are host-root-equivalent; disabled unless the
    operator sets docker.volumes.enabled (drivers/docker volumes gate)."""

    def test_volumes_rejected_by_default(self):
        with pytest.raises(ValueError, match="volumes are disabled"):
            DockerDriver()._command(
                cfg({"image": "nginx", "volumes": ["/:/host"]}))

    def test_volumes_allowed_when_enabled(self):
        drv = DockerDriver(options={"docker.volumes.enabled": "true"})
        argv = drv._command(
            cfg({"image": "nginx", "volumes": ["/data:/data"]}))
        assert "-v" in argv and "/data:/data" in argv

    def test_no_volumes_fine_without_flag(self):
        argv = DockerDriver()._command(cfg({"image": "nginx"}))
        assert "-v" not in argv


class TestJavaFingerprintDepth:
    """driver.java.version/runtime/vm attributes from `java -version`
    (drivers/java/utils.go parse semantics), via a fake JVM binary."""

    FAKE = (
        "#!/bin/sh\n"
        "echo 'openjdk version \"17.0.2\" 2022-01-18' >&2\n"
        "echo 'OpenJDK Runtime Environment (build 17.0.2+8-86)' >&2\n"
        "echo 'OpenJDK 64-Bit Server VM (build 17.0.2+8-86, mixed mode)'"
        " >&2\n"
    )

    def test_version_runtime_vm_attributes(self, tmp_path):
        import os
        import stat

        fake = tmp_path / "java"
        fake.write_text(self.FAKE)
        os.chmod(fake, stat.S_IRWXU)
        drv = JavaDriver()
        drv.java_bin = str(fake)
        fp = drv.fingerprint()
        assert fp.attributes["driver.java.version"] == "17.0.2"
        assert "Runtime Environment" in fp.attributes["driver.java.runtime"]
        assert "VM" in fp.attributes["driver.java.vm"]

    def test_parse_helper(self):
        from nomad_tpu_torch.drivers.java import parse_java_version

        v, rt, vm = parse_java_version(
            'java version "1.8.0_292"\n'
            "Java(TM) SE Runtime Environment (build 1.8.0_292-b10)\n"
            "Java HotSpot(TM) 64-Bit Server VM (build 25.292-b10)\n")
        assert v == "1.8.0_292"
        assert "Runtime Environment" in rt
        assert "VM" in vm

    def test_executor_resource_opts(self):
        """The JVM runs under the isolating executor with cgroup
        limits from the task resources (driver.go StartTask)."""
        from nomad_tpu_torch.drivers.execdriver import isolation_support

        drv = JavaDriver()
        res = structs.Resources(cpu=750, memory_mb=640)
        opts = drv._executor_opts(cfg({"jar_path": "/a.jar"},
                                      resources=res))
        support = isolation_support()
        if support["cgroups"]:
            assert "-mem_mb" in opts and "640" in opts
            assert "-cpu_shares" in opts and "750" in opts
        if support["namespaces"]:
            assert "-isolate" in opts


class TestQemuGracefulShutdown:
    """QMP monitor-socket shutdown (drivers/qemu/driver.go StopTask's
    graceful path), against a scripted QMP endpoint."""

    def _fake_qmp(self, path, received):
        import json
        import socket
        import threading

        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(path)
        srv.listen(1)

        def serve():
            conn, _ = srv.accept()
            f = conn.makefile("rwb")
            f.write(json.dumps(
                {"QMP": {"version": {}, "capabilities": []}}).encode()
                + b"\n")
            f.flush()
            for line in f:
                msg = json.loads(line)
                received.append(msg.get("execute"))
                f.write(b'{"return": {}}\n')
                f.flush()
                if msg.get("execute") == "system_powerdown":
                    break
            conn.close()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        return srv

    def test_monitor_arg_in_command(self):
        res = structs.Resources(memory_mb=512)
        c = cfg({"image_path": "/img/linux.img"}, resources=res)
        drv = QemuDriver()
        argv = drv._command(c)
        qmp = argv[argv.index("-qmp") + 1]
        assert qmp.startswith("unix:") and qmp.endswith(",server,nowait")
        assert drv.monitor_path(c) in qmp

    def test_graceful_shutdown_disabled_drops_monitor(self):
        res = structs.Resources(memory_mb=512)
        argv = QemuDriver()._command(cfg({
            "image_path": "/img/linux.img", "graceful_shutdown": False,
        }, resources=res))
        assert "-qmp" not in argv

    def test_qmp_system_powerdown_handshake(self, tmp_path):
        received = []
        path = str(tmp_path / "qmp.sock")
        srv = self._fake_qmp(path, received)
        try:
            ok = QemuDriver.qmp_system_powerdown(path, timeout=5.0)
        finally:
            srv.close()
        assert ok
        assert received == ["qmp_capabilities", "system_powerdown"]

    def test_stop_task_prefers_graceful(self, tmp_path):
        """stop_task sends system_powerdown and waits for the VM to
        exit on its own before any signal."""
        import threading

        drv = QemuDriver()
        c = cfg({"image_path": "/img/linux.img"})
        c.alloc_dir = str(tmp_path)
        # a fake running task whose monitor socket is our scripted QMP
        from nomad_tpu_torch.drivers.rawexec import _RawTask

        task = _RawTask(c)
        task.pid = task.pgid = 999999999        # never signalled
        drv._tasks[c.id] = task
        received = []
        srv = self._fake_qmp(drv.monitor_path(c), received)

        def guest_exits():
            # the guest "powers down" shortly after the QMP command
            while "system_powerdown" not in received:
                pass
            task.done.set()

        threading.Thread(target=guest_exits, daemon=True).start()
        try:
            drv.stop_task(c.id, timeout=5.0)
        finally:
            srv.close()
        assert task.done.is_set()
        assert received == ["qmp_capabilities", "system_powerdown"]
