"""docker driver: container workloads via the docker CLI.

Reference behavior: drivers/docker/ (10.9k LoC against the daemon API)
-- fingerprints the daemon (driver.docker.version; undetected when the
socket is absent), runs containers with resource limits, env, port
publishing, and log collection, and stops via the engine so the
container gets a graceful shutdown window.

This build drives the docker CLI: a foreground ``docker run`` process
is supervised by the shared executor (signals proxy through the CLI),
while stop/destroy go through ``docker stop``/``docker rm`` so
engine-side state is cleaned up. Operational surface beyond run/stop:

- image pulls are singleflighted per image across concurrent tasks
  (coordinator.go), probing ``docker image inspect`` first
- ``task_stats`` reads RAW stats from the engine API over the unix
  socket (drivers/docker/stats.go semantics: cpu-delta math over
  precpu, memory usage net of reclaimable cache; docker_api.py) with
  CLI and process-stats fallbacks
- a detached ``docklog`` subprocess follows the container's log
  stream from the ENGINE into the task log files
  (docklog/docklog.go): output keeps flowing across agent restarts
  independent of the CLI attachment, and recover_task respawns a dead
  docklog; without a live engine socket the foreground ``docker run``
  still writes through the executor into the logmon collector
- interactive exec streams through ``docker exec -i[t]`` INSIDE the
  container (driver.proto:79)

Gated: nodes without a reachable daemon fingerprint as undetected and
never receive docker tasks.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

from nomad_tpu_torch.drivers.rawexec import ExecStream, RawExecDriver
from nomad_tpu_torch.plugins.base import PLUGIN_TYPE_DRIVER, PluginInfo
from nomad_tpu_torch.plugins.drivers import (
    HEALTH_HEALTHY,
    HEALTH_UNDETECTED,
    DriverCapabilities,
    Fingerprint,
    NetworkIsolationSpec,
    TaskConfig,
    TaskHandle,
)


def _container_name(config: TaskConfig) -> str:
    return f"nomad-{config.name}-{config.alloc_id[:8] or config.id[:8]}"


def _registry_of(image: str) -> str:
    """Registry host of an image reference (driver.go repository
    parsing): 'gcr.io/proj/app:v1' -> 'gcr.io'; bare names -> the
    default index."""
    first = image.split("/", 1)[0]
    if "/" in image and ("." in first or ":" in first
                        or first == "localhost"):
        return first
    return "https://index.docker.io/v1/"


class ImageCoordinator:
    """Reference-counted image lifecycle (drivers/docker/coordinator.go):
    every running task holds a reference on its image; when the last
    reference drops, removal is scheduled after ``remove_delay`` so a
    rescheduled task can reuse the layer cache; a new reference before
    the deadline cancels the removal."""

    def __init__(self, remove_delay: float = 180.0,
                 cleanup: bool = True, lock_for=None) -> None:
        self.remove_delay = remove_delay
        self.cleanup = cleanup
        self._lock = threading.Lock()
        self._refs: Dict[str, set] = {}
        self._timers: Dict[str, threading.Timer] = {}
        # per-image serialization with the driver's pull/probe path:
        # rmi takes the same lock _ensure_image pulls under, so a
        # concurrent probe can never see the image mid-removal, skip
        # the pull, and then fail its container start
        self._own_locks: Dict[str, threading.Lock] = {}
        self._lock_for = lock_for or self._default_lock_for

    def _default_lock_for(self, image: str) -> threading.Lock:
        with self._lock:
            return self._own_locks.setdefault(image, threading.Lock())

    def use(self, image: str, task_id: str) -> None:
        with self._lock:
            self._refs.setdefault(image, set()).add(task_id)
            timer = self._timers.pop(image, None)
        if timer is not None:
            timer.cancel()

    def release(self, image: str, task_id: str) -> None:
        with self._lock:
            refs = self._refs.get(image)
            if refs is None:
                return
            refs.discard(task_id)
            if refs or not self.cleanup:
                return
            del self._refs[image]
            old = self._timers.pop(image, None)
            timer = threading.Timer(
                self.remove_delay, self._remove, args=(image,))
            timer.daemon = True
            self._timers[image] = timer
        if old is not None:
            old.cancel()
        timer.start()

    def _remove(self, image: str) -> None:
        # the pull lock serializes rmi against _ensure_image's
        # probe+pull, closing the window where a probe sees the image
        # present mid-rmi (the rmi subprocess can take up to 120s)
        with self._lock_for(image):
            with self._lock:
                self._timers.pop(image, None)
                # last-instant re-check: a use() racing the timer fire
                # must win
                if self._refs.get(image):
                    return
            try:
                subprocess.run(["docker", "rmi", image],
                               capture_output=True, timeout=120)
            except Exception:               # noqa: BLE001
                pass

    def shutdown(self) -> None:
        with self._lock:
            timers = list(self._timers.values())
            self._timers.clear()
        for t in timers:
            t.cancel()


class DockerDriver(RawExecDriver):
    name = "docker"

    def __init__(self, options: Optional[Dict[str, str]] = None) -> None:
        super().__init__()
        opts = options or {}
        # Host bind mounts are host-root-equivalent for job submitters,
        # so the reference disables them unless the operator opts in
        # (drivers/docker config "volumes.enabled", default false).
        self.volumes_enabled = str(
            opts.get("docker.volumes.enabled", "false")).lower() in (
                "1", "true", "yes")
        # registry auth backends (driver.go:604
        # resolveRegistryAuthentication): a docker config FILE and/or a
        # credential HELPER configured by the operator; the task's own
        # auth block is checked first
        self.auth_config_file = opts.get("docker.auth.config", "")
        self.auth_helper = opts.get("docker.auth.helper", "")
        # pause/infra container image for driver-created group networks
        # (drivers/docker/network.go, config "infra_image")
        self.infra_image = opts.get(
            "docker.infra_image", "gcr.io/google_containers/pause-amd64:3.3")
        # image refcount GC (coordinator.go): delayed removal after the
        # last task using an image stops
        self.images = ImageCoordinator(
            remove_delay=float(opts.get("docker.cleanup.image.delay",
                                        "180")),
            cleanup=str(opts.get("docker.cleanup.image", "true")).lower()
            in ("1", "true", "yes"),
            lock_for=self._pull_lock_for,
        )

    #: image -> lock: concurrent tasks of one image pull it ONCE
    #: (drivers/docker/coordinator.go singleflight)
    _pull_locks: Dict[str, threading.Lock] = {}
    _pull_locks_guard = threading.Lock()

    def plugin_info(self) -> PluginInfo:
        return PluginInfo(name=self.name, type=PLUGIN_TYPE_DRIVER)

    def capabilities(self) -> DriverCapabilities:
        caps = super().capabilities()
        # containers cannot join a client-made netns: docker builds the
        # group sandbox itself (network.go MustInitiateNetwork)
        caps.must_create_network = True
        return caps

    # -- DriverNetworkManager (drivers/docker/network.go) ----------------

    @staticmethod
    def _pause_name(alloc_id: str) -> str:
        return f"nomad-pause-{alloc_id[:8]}"

    def create_network(self, alloc_id: str,
                       port_mappings=None) -> NetworkIsolationSpec:
        """Start the allocation's pause container: every task container
        joins ITS network namespace (``--network container:<pause>``),
        so group tasks share localhost; the scheduler's host-port
        assignments publish on the pause container (the namespace
        owner), exactly like the reference's infra container."""
        name = self._pause_name(alloc_id)
        self._ensure_image(self.infra_image)
        # idempotent: a stale pause container from a crashed prior
        # attempt (or a destroy the agent never ran) would make --name
        # conflict permanently
        subprocess.run(["docker", "rm", "-f", name],
                       capture_output=True, timeout=30)
        argv = ["docker", "run", "-d", "--name", name]
        for host, container in port_mappings or []:
            argv += ["-p", f"{host}:{container}"]
        argv.append(self.infra_image)
        out = subprocess.run(argv, capture_output=True, timeout=120)
        if out.returncode != 0:
            subprocess.run(["docker", "rm", "-f", name],
                           capture_output=True, timeout=30)
            raise RuntimeError(
                f"pause container: "
                f"{out.stderr.decode(errors='replace')[:300]}")
        return NetworkIsolationSpec(
            mode="group", ip=self._sandbox_ip(name),
            labels={"docker_sandbox_container": name})

    def _sandbox_ip(self, name: str) -> str:
        out = subprocess.run(
            ["docker", "inspect", "-f",
             "{{range .NetworkSettings.Networks}}{{.IPAddress}}{{end}}",
             name],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() if out.returncode == 0 else ""

    def recover_network(self, alloc_id: str, port_mappings=None
                        ) -> Optional[NetworkIsolationSpec]:
        """Re-adopt a pause container that outlived the agent. The
        container must be RUNNING: containers cannot join the network
        of an exited one, so a stopped sandbox (host reboot) is removed
        and recreated with its original port mappings."""
        name = self._pause_name(alloc_id)
        probe = subprocess.run(
            ["docker", "inspect", "-f", "{{.State.Running}}", name],
            capture_output=True, text=True, timeout=30)
        if probe.returncode != 0:
            return None
        if probe.stdout.strip() != "true":
            return self.create_network(alloc_id, port_mappings)
        return NetworkIsolationSpec(
            mode="group", ip=self._sandbox_ip(name),
            labels={"docker_sandbox_container": name})

    def destroy_network(self, alloc_id: str,
                        spec: NetworkIsolationSpec) -> None:
        name = ((spec.labels or {}).get("docker_sandbox_container")
                if spec is not None else "") or self._pause_name(alloc_id)
        subprocess.run(["docker", "rm", "-f", name],
                       capture_output=True, timeout=30)

    # -- registry authentication (driver.go:604) -------------------------

    def _resolve_registry_auth(self, image: str,
                               task_auth: Optional[Dict] = None
                               ) -> Optional[Dict[str, str]]:
        """Backend chain, first hit wins: the task's own ``auth`` block,
        the operator's docker config file (auths + credHelpers), then
        the operator's credential helper
        (``docker-credential-<helper> get``)."""
        import base64

        registry = _registry_of(image)
        if task_auth and task_auth.get("username"):
            return {"username": str(task_auth["username"]),
                    "password": str(task_auth.get("password", "")),
                    "server": str(task_auth.get("server_address")
                                  or registry)}
        if self.auth_config_file:
            try:
                with open(self.auth_config_file) as f:
                    cfg = json.load(f)
            except (OSError, json.JSONDecodeError):
                cfg = {}
            entry = (cfg.get("auths") or {}).get(registry)
            if entry is None and registry.startswith("https://"):
                entry = (cfg.get("auths") or {}).get(
                    registry.removeprefix("https://"))
            if entry and entry.get("auth"):
                try:
                    user, _, pw = base64.b64decode(
                        entry["auth"]).decode().partition(":")
                    return {"username": user, "password": pw,
                            "server": registry}
                except Exception:       # noqa: BLE001
                    pass
            helper = (cfg.get("credHelpers") or {}).get(registry)
            if helper:
                got = self._run_cred_helper(helper, registry)
                if got:
                    return got
        if self.auth_helper:
            return self._run_cred_helper(self.auth_helper, registry)
        return None

    @staticmethod
    def _run_cred_helper(helper: str, registry: str
                         ) -> Optional[Dict[str, str]]:
        """`docker-credential-<helper> get` speaking the credential
        helper protocol (docker-credential-helpers wire shape)."""
        try:
            out = subprocess.run(
                [f"docker-credential-{helper}", "get"],
                input=registry.encode(), capture_output=True, timeout=30,
            )
            if out.returncode != 0:
                return None
            got = json.loads(out.stdout.decode())
            return {"username": str(got.get("Username", "")),
                    "password": str(got.get("Secret", "")),
                    "server": str(got.get("ServerURL") or registry)}
        except Exception:               # noqa: BLE001
            return None

    # -- image pull coordination (coordinator.go) ------------------------

    @classmethod
    def _pull_lock_for(cls, image: str) -> threading.Lock:
        with cls._pull_locks_guard:
            return cls._pull_locks.setdefault(image, threading.Lock())

    def _ensure_image(self, image: str, timeout: float = 600.0,
                      task_auth: Optional[Dict] = None) -> None:
        with self._pull_lock_for(image):
            probe = subprocess.run(
                ["docker", "image", "inspect", image],
                capture_output=True, timeout=60,
            )
            if probe.returncode == 0:
                return
            auth = self._resolve_registry_auth(image, task_auth)
            argv, cfg_dir = ["docker"], None
            if auth is not None:
                # an ephemeral --config dir carries the credentials to
                # THIS pull only (the API-path X-Registry-Auth analog)
                # without touching the operator's docker login state
                import base64
                import tempfile

                cfg_dir = tempfile.mkdtemp(prefix="nomad-docker-auth-")
                token = base64.b64encode(
                    f"{auth['username']}:{auth['password']}".encode()
                ).decode()
                with open(f"{cfg_dir}/config.json", "w") as f:
                    json.dump(
                        {"auths": {auth["server"]: {"auth": token}}}, f)
                argv += ["--config", cfg_dir]
            try:
                pull = subprocess.run(
                    argv + ["pull", image],
                    capture_output=True, timeout=timeout,
                )
            finally:
                if cfg_dir is not None:
                    shutil.rmtree(cfg_dir, ignore_errors=True)
            if pull.returncode != 0:
                raise RuntimeError(
                    f"docker pull {image}: "
                    f"{pull.stderr.decode(errors='replace')[:300]}"
                )

    #: engine socket; overridable for tests (fake engine)
    engine_socket = "/var/run/docker.sock"

    def _engine(self, ping: bool = True):
        """Engine API client when the daemon socket answers, else
        None (CLI fallbacks remain). ``ping=False`` skips the probe
        roundtrip for callers that already handle call failure."""
        import os

        from nomad_tpu_torch.drivers.docker_api import DockerEngine

        if not os.path.exists(self.engine_socket):
            return None
        try:
            engine = DockerEngine(self.engine_socket)
            if ping and not engine.ping():
                return None
            return engine
        except Exception:                       # noqa: BLE001
            return None

    def start_task(self, config: TaskConfig) -> TaskHandle:
        import os

        image = config.driver_config.get("image")
        if not image:
            raise ValueError("docker driver requires image")
        # reference BEFORE the pull (coordinator.go registers inside
        # PullImage): a pending removal timer is cancelled before the
        # inspect probe can be invalidated by it
        self.images.use(image, config.id)
        try:
            self._ensure_image(image,
                               task_auth=config.driver_config.get("auth"))
            engine_live = self._engine() is not None
            real_out, real_err = config.std_out_path, config.std_err_path
            if engine_live:
                # docklog is the log path (the reference never attaches
                # `docker run` output either); the CLI attachment would
                # write every container line a second time
                config.std_out_path = os.devnull
                config.std_err_path = os.devnull
            try:
                handle = super().start_task(config)
            finally:
                config.std_out_path, config.std_err_path = \
                    real_out, real_err
        except BaseException:
            # a failed start must not strand the reference (the image
            # would be exempt from GC forever)
            self.images.release(image, config.id)
            raise
        if engine_live:
            self._start_docklog(config, handle, engine_checked=True)
        return handle

    # -- docklog (drivers/docker/docklog/docklog.go) ---------------------

    def _start_docklog(self, config: TaskConfig, handle: TaskHandle,
                       since: int = 0, engine_checked: bool = False) -> None:
        """Detached engine-log follower: task output keeps flowing
        across agent restarts independent of the CLI attachment. Only
        when the engine socket is live (CLI-attached logs still work
        through the executor/logmon path otherwise). ``since`` bounds
        a respawned follower so history is not re-appended."""
        import os
        import sys as _sys

        if not engine_checked and self._engine() is None:
            return
        workdir = config.alloc_dir or "/tmp"
        stdout = config.std_out_path or os.path.join(workdir, "stdout")
        stderr = config.std_err_path or os.path.join(workdir, "stderr")
        script = os.path.join(os.path.dirname(__file__), "docklog.py")
        proc = subprocess.Popen(
            [_sys.executable, "-S", script, self.engine_socket,
             _container_name(config), stdout, stderr, str(since)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        handle.driver_state["docklog_pid"] = proc.pid

    def recover_task(self, handle: TaskHandle) -> None:
        super().recover_task(handle)
        # the recovered task holds its image reference again
        # (coordinator.go re-registers on recovery)
        image = handle.config.driver_config.get("image")
        if image:
            self.images.use(image, handle.config.id)
        # docklog survives with the task; respawn only when it died
        # (docklog.go reattach-or-restart on recover)
        import os

        pid = int(handle.driver_state.get("docklog_pid") or 0)
        alive = False
        if pid > 0:
            try:
                os.kill(pid, 0)
                alive = True
            except OSError:
                alive = False
        if not alive:
            # resume from now: history is already in the files (the
            # reference docklog resumes from a saved timestamp)
            import time as _time

            self._start_docklog(handle.config, handle,
                                since=int(_time.time()))

    def fingerprint(self) -> Fingerprint:
        docker = shutil.which("docker")
        if docker is None:
            return Fingerprint(health=HEALTH_UNDETECTED,
                               health_description="docker not found")
        try:
            out = subprocess.run(
                [docker, "version", "--format", "{{.Server.Version}}"],
                capture_output=True, text=True, timeout=10,
            )
            if out.returncode != 0:
                return Fingerprint(
                    health=HEALTH_UNDETECTED,
                    health_description="docker daemon unreachable",
                )
            version = out.stdout.strip()
        except Exception:                       # noqa: BLE001
            return Fingerprint(health=HEALTH_UNDETECTED,
                               health_description="docker daemon unreachable")
        return Fingerprint(
            attributes={f"driver.{self.name}": "1",
                        "driver.docker.version": version},
            health=HEALTH_HEALTHY,
            health_description="Healthy",
        )

    def task_config_schema(self) -> Dict:
        return {
            "image": {"type": "string", "required": True},
            "command": {"type": "string"},
            "args": {"type": "list"},
            "ports": {"type": "list"},        # port labels to publish
            "volumes": {"type": "list"},      # host:container binds
            "network_mode": {"type": "string"},
        }

    def _command(self, config: TaskConfig) -> List[str]:
        cfg = config.driver_config
        image = cfg.get("image")
        if not image:
            raise ValueError("docker driver requires image")
        argv: List[str] = [
            "docker", "run", "--rm", "--init",
            "--name", _container_name(config),
        ]
        if config.resources.memory_mb:
            argv += ["--memory", f"{config.resources.memory_mb}m"]
        if config.resources.cpu:
            # MHz shares -> relative CPU weight (docker driver
            # cpu_shares mapping)
            argv += ["--cpu-shares", str(config.resources.cpu)]
        for key, value in config.env.items():
            argv += ["-e", f"{key}={value}"]
        sandbox = ""
        if config.network_isolation is not None:
            sandbox = (config.network_isolation.labels or {}).get(
                "docker_sandbox_container", "")
        if sandbox:
            # join the driver-created group namespace; ports publish on
            # the pause container (the namespace owner), so per-task
            # -p flags are invalid here (network.go)
            argv += ["--network", f"container:{sandbox}"]
        elif cfg.get("network_mode"):
            argv += ["--network", cfg["network_mode"]]
        if not sandbox:
            for label in cfg.get("ports") or []:
                for net in config.resources.networks:
                    assigned = net.port_for_label(label)
                    if assigned:
                        for p in (list(net.reserved_ports)
                                  + list(net.dynamic_ports)):
                            if p.label == label:
                                argv += ["-p",
                                         f"{assigned}:{p.to or assigned}"]
        if cfg.get("volumes"):
            if not self.volumes_enabled:
                # reject, never silently drop binds the task depends on
                raise ValueError(
                    "docker volumes are disabled on this client; set "
                    "client option docker.volumes.enabled=true")
            for bind in cfg["volumes"]:
                argv += ["-v", bind]
        argv.append(image)
        if cfg.get("command"):
            argv.append(cfg["command"])
        argv.extend(cfg.get("args") or [])
        return argv

    def _build_env(self, config: TaskConfig) -> Dict[str, str]:
        # env goes into the container via -e flags; the docker CLI
        # itself just needs a sane PATH/HOME
        import os

        return {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                "HOME": os.environ.get("HOME", "/tmp")}

    def stop_task(self, task_id: str, timeout: float = 5.0,
                  signal: str = "SIGTERM") -> None:
        task = self._tasks.get(task_id)
        if task is not None:
            subprocess.run(
                ["docker", "stop", "-t", str(int(timeout)),
                 _container_name(task.config)],
                capture_output=True, timeout=timeout + 10,
            )
        super().stop_task(task_id, timeout=timeout, signal=signal)

    def destroy_task(self, task_id: str, force: bool = False) -> None:
        task = self._tasks.get(task_id)
        # super() validates first (a live task without force raises):
        # the container removal and the image-reference drop happen
        # only when the destroy actually goes through
        super().destroy_task(task_id, force=force)
        if task is not None:
            subprocess.run(
                ["docker", "rm", "-f", _container_name(task.config)],
                capture_output=True, timeout=30,
            )
            # the engine closes the log stream when the container goes;
            # docklog exits on its own — nothing to reap here beyond
            # the normal child cleanup
            image = task.config.driver_config.get("image")
            if image:
                self.images.release(image, task.config.id)

    def exec_task(self, task_id: str, cmd: List[str],
                  timeout: float = 30.0) -> Dict:
        task = self._tasks.get(task_id)
        if task is None:
            raise KeyError(f"unknown task {task_id}")
        out = subprocess.run(
            ["docker", "exec", _container_name(task.config)] + cmd,
            capture_output=True, text=True, timeout=timeout,
        )
        return {"stdout": out.stdout, "stderr": out.stderr,
                "exit_code": out.returncode}

    def exec_task_streaming(self, task_id: str, cmd: List[str],
                            tty: bool = False) -> ExecStream:
        """Interactive exec INSIDE the container (driver.proto:79 via
        `docker exec -i[t]`)."""
        task = self._get(task_id)
        flags = ["-it" if tty else "-i"]
        return ExecStream(
            ["docker", "exec", *flags, _container_name(task.config)] + cmd,
            cwd=task.config.alloc_dir or "/tmp", tty=tty,
            env=self._build_env(task.config),
        )

    def task_stats(self, task_id: str) -> Dict:
        """Container stats from the engine API (drivers/docker/stats.go:
        raw cgroup counters + cpu-delta math), falling back to the CLI
        then to process stats."""
        task = self._get(task_id)
        # no ping: the stats call itself is the probe (halves socket
        # traffic on the collection hot path); any transport flake
        # falls back to the CLI below
        engine = self._engine(ping=False)
        if engine is not None:
            from nomad_tpu_torch.drivers.docker_api import (
                TRANSPORT_ERRORS,
                EngineError,
                compute_cpu_percent,
                memory_rss,
            )

            try:
                raw = engine.stats(_container_name(task.config))
                return {
                    "cpu": {"percent": compute_cpu_percent(raw)},
                    "memory": {"rss": memory_rss(raw)},
                }
            except TRANSPORT_ERRORS + (EngineError,):
                pass
        out = subprocess.run(
            ["docker", "stats", "--no-stream", "--format", "{{json .}}",
             _container_name(task.config)],
            capture_output=True, text=True, timeout=30,
        )
        stats: Dict = {"cpu": {}, "memory": {}}
        if out.returncode != 0 or not out.stdout.strip():
            return super().task_stats(task_id)
        try:
            row = json.loads(out.stdout.strip().splitlines()[0])
        except json.JSONDecodeError:
            return super().task_stats(task_id)
        cpu = str(row.get("CPUPerc", "")).rstrip("%")
        try:
            stats["cpu"]["percent"] = float(cpu)
        except ValueError:
            pass
        mem = str(row.get("MemUsage", "")).split("/")[0].strip()
        stats["memory"]["rss"] = _parse_size(mem)
        return stats


_SIZE_UNITS = {"b": 1, "kb": 1000, "kib": 1024, "mb": 1000 ** 2,
               "mib": 1024 ** 2, "gb": 1000 ** 3, "gib": 1024 ** 3}


def _parse_size(text: str) -> int:
    """'21.48MiB' -> bytes (docker stats human units)."""
    import re

    m = re.fullmatch(r"([\d.]+)\s*([A-Za-z]+)", text.strip())
    if not m:
        return 0
    try:
        value = float(m.group(1))
    except ValueError:
        return 0
    return int(value * _SIZE_UNITS.get(m.group(2).lower(), 1))
