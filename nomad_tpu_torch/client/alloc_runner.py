"""AllocRunner: per-allocation lifecycle.

Reference behavior: client/allocrunner/alloc_runner.go -- owns the
alloc dir, runs the hook chain (here: allocdir setup), builds one
TaskRunner per task in the group, aggregates task states into the
alloc's client status (alloc_runner.go clientAlloc/getClientStatus),
and reports updates to the client for batched upload to servers.
"""

from __future__ import annotations

import copy
import logging
import os
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional

from nomad_tpu_torch.client.task_runner import STATE_DEAD, STATE_PENDING, STATE_RUNNING, TaskRunner
from nomad_tpu_torch.structs import consts
from nomad_tpu_torch.structs.alloc import Allocation, TaskState

LOG = logging.getLogger(__name__)


class AllocRunner:
    def __init__(
        self,
        alloc: Allocation,
        drivers: Dict[str, object],
        data_dir: str,
        on_alloc_update: Callable[[Allocation], None],
        state_db=None,
        csi_manager=None,
        service_reg=None,
        secrets=None,
        prev_lookup=None,
        device_plugins=None,
        network_manager=None,
        connect_mgr=None,
    ) -> None:
        self.alloc = alloc
        self.drivers = drivers
        self.data_dir = data_dir
        self.on_alloc_update = on_alloc_update
        self.state_db = state_db
        self.csi_manager = csi_manager
        self.service_reg = service_reg
        self.secrets = secrets
        # resolves a previous alloc id to its local runner
        # (allocwatcher; None for client-less/test topologies)
        self.prev_lookup = prev_lookup
        # device plugins for Reserve (devicemanager; device.proto)
        self.device_plugins = device_plugins or []
        # bridge networking (network_hook.go); None when unsupported
        self.network_manager = network_manager
        self.alloc_network = None
        # (driver, NetworkIsolationSpec) when the group's driver built
        # the namespace itself (DriverNetworkManager)
        self.driver_network = None
        # Connect hook (envoy_bootstrap_hook analog); None without the
        # mesh RPC verbs
        self.connect_mgr = connect_mgr
        self.alloc_connect = None
        # tasks whose services are currently registered
        self._registered_tasks: set = set()
        # volume name -> CSIMountInfo (csi_hook.go populates these for
        # task volume_mounts)
        self.csi_mounts: Dict[str, object] = {}
        self.alloc_dir = os.path.join(data_dir, "allocs", alloc.id)
        self.task_runners: Dict[str, TaskRunner] = {}
        self._lock = threading.Lock()
        self._destroyed = False
        self._stop_requested = False
        # True once run()/restore() is past task-runner creation (or
        # has decided it never will be); _await_previous keys on it so
        # a same-batch predecessor isn't mistaken for "done" while its
        # task_runners dict is still empty
        self._tasks_started = False
        self._waiter: Optional[threading.Thread] = None
        self.task_states: Dict[str, TaskState] = {}

    # --- lifecycle ------------------------------------------------------

    def run(self) -> None:
        """alloc_runner.go Run: prerun hooks then task runners."""
        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job is not None else None
        if tg is None:
            LOG.warning("alloc %s: unknown task group %s",
                        self.alloc.id, self.alloc.task_group)
            self._tasks_started = True
            return
        os.makedirs(self.alloc_dir, exist_ok=True)
        # upstream-alloc prerun hook (allocwatcher/alloc_watcher.go):
        # wait out the previous allocation, then migrate its ephemeral
        # disk when the group asks for it
        self._await_previous(tg)
        if self._destroyed or self._stop_requested:
            # stopped/GC'd while waiting: never start tasks for a dead
            # alloc (the wait returns early on both flags)
            self._tasks_started = True
            return
        # CSI prerun hook (allocrunner/csi_hook.go): claim + mount each
        # requested volume before any task starts; a claim failure fails
        # the whole alloc
        if self.csi_manager is not None:
            for name, req in tg.volumes.items():
                if req.type != "csi":
                    continue
                try:
                    self.csi_mounts[name] = \
                        self.csi_manager.mount_volume(self.alloc, req)
                except Exception as e:          # noqa: BLE001
                    LOG.warning("alloc %s: csi mount %s: %s",
                                self.alloc.id, name, e)
                    self._fail_alloc(tg)
                    return
        # bridge-network prerun hook (network_hook.go): a bridge-mode
        # group gets its own netns + veth before any task starts; the
        # scheduler's host ports relay to the alloc's namespace IP
        netns_name = ""
        net_env: Dict[str, str] = {}
        wants_bridge = any(
            getattr(n, "mode", "host") == "bridge" for n in tg.networks
        )
        mappings = self._port_mappings() if wants_bridge else []
        # driver-managed group network (drivers/driver.go:92
        # DriverNetworkManager): when the group's (single) driver MUST
        # own the namespace — docker's pause container — the client
        # delegates instead of building its own netns. Connect sidecar
        # groups stay on the client netns: the mesh proxies enter the
        # namespace via `ip netns exec`, which a driver-owned sandbox
        # does not expose (documented deviation).
        net_driver = self._group_network_driver(tg)
        if net_driver is not None and not any(
                svc.has_sidecar() for svc in tg.services):
            try:
                spec = net_driver.create_network(self.alloc.id, mappings)
            except Exception as e:              # noqa: BLE001
                LOG.warning("alloc %s: driver network setup failed: %s",
                            self.alloc.id, e)
                self._fail_alloc(tg)
                return
            if spec is not None:
                self.driver_network = (net_driver, spec)
                netns_name = spec.netns
                if spec.ip:
                    net_env["NOMAD_ALLOC_IP"] = spec.ip
            # spec None = the driver declined: the client path below
            # owns bridge networking after all
        if wants_bridge and self.driver_network is None \
                and self.network_manager is not None:
            try:
                self.alloc_network = self.network_manager.create(
                    self.alloc.id, mappings)
                netns_name = self.alloc_network.ns_name
                net_env["NOMAD_ALLOC_IP"] = self.alloc_network.ip
            except Exception as e:              # noqa: BLE001
                LOG.warning("alloc %s: bridge network setup failed: %s",
                            self.alloc.id, e)
                self._fail_alloc(tg)
                return
        elif wants_bridge and self.driver_network is None:
            LOG.warning("alloc %s: bridge networking requested but "
                        "unsupported on this client; tasks run in the "
                        "host network", self.alloc.id)
        # connect hook (envoy_bootstrap_hook/connect_native_hook): mesh
        # sidecar + upstream proxies before any task starts, so a
        # task's first upstream dial finds its local listener
        if self.connect_mgr is not None:
            try:
                self.alloc_connect = self.connect_mgr.setup(
                    self.alloc, tg, self.alloc_network)
                if self.alloc_connect is not None:
                    net_env.update(self.alloc_connect.env)
            except Exception as e:              # noqa: BLE001
                LOG.warning("alloc %s: connect setup failed: %s",
                            self.alloc.id, e)
                self._fail_alloc(tg)
                return
        # mount paths surface to tasks as env (the reference bind-mounts
        # them into the task via VolumeMounts; env is this build's
        # equivalent until drivers gain mount plumbing)
        volume_env = {
            f"NOMAD_ALLOC_VOLUME_{name.upper().replace('-', '_')}":
                m.target_path
            for name, m in self.csi_mounts.items()
        }
        for task in tg.tasks:
            driver = self.drivers.get(task.driver)
            if driver is None:
                ts = TaskState(state=STATE_DEAD, failed=True)
                self._on_task_state(task.name, ts)
                LOG.warning("alloc %s: no driver %s", self.alloc.id, task.driver)
                continue
            task_env = dict(volume_env)
            task_env.update(net_env)
            try:
                task_env.update(self._reserve_devices(task.name))
            except Exception as e:              # noqa: BLE001
                LOG.warning("alloc %s: device reserve for %s failed: %s",
                            self.alloc.id, task.name, e)
                self._on_task_state(
                    task.name, TaskState(state=STATE_DEAD, failed=True))
                continue
            tr = TaskRunner(
                alloc=self.alloc,
                task=task,
                driver=driver,
                alloc_dir=self.alloc_dir,
                on_state_change=self._on_task_state,
                state_db=self.state_db,
                restart_policy=tg.restart_policy,
                extra_env=task_env,
                secrets=self.secrets,
                netns=netns_name,
                network_isolation=(self.driver_network[1]
                                   if self.driver_network else None),
            )
            self.task_runners[task.name] = tr
            tr.start()
        self._tasks_started = True
        self._watch_done()

    def _fail_alloc(self, tg) -> None:
        """A prerun hook failed: every task is dead-failed and the
        runner reads as started (so is_done/GC proceed)."""
        for task in tg.tasks:
            self._on_task_state(
                task.name, TaskState(state=STATE_DEAD, failed=True))
        self._tasks_started = True

    def _port_mappings(self) -> List:
        """[(host_port, container_port)] from the scheduler's
        assignment; group ports appear both in shared.ports and inside
        shared.networks."""
        by_host: Dict[int, int] = {}
        res = self.alloc.allocated_resources
        if res is not None:
            for p in res.shared.ports:
                by_host[p.value] = p.to or p.value
            for net in res.shared.networks:
                for p in (list(net.reserved_ports)
                          + list(net.dynamic_ports)):
                    by_host.setdefault(p.value, p.to or p.value)
        return sorted(by_host.items())

    def _group_network_driver(self, tg):
        """The single driver that must own this bridge group's network
        (DriverNetworkManager + MustInitiateNetwork), or None."""
        if not any(getattr(n, "mode", "host") == "bridge"
                   for n in tg.networks):
            return None
        names = {task.driver for task in tg.tasks}
        if len(names) != 1:
            return None
        cand = self.drivers.get(next(iter(names)))
        if cand is not None and cand.capabilities().must_create_network:
            return cand
        return None

    def restore(self) -> None:
        """Rebuild task runners after agent restart, reattaching to live
        tasks (alloc_runner restore path; client.go:1109)."""
        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job is not None else None
        if tg is None:
            self._tasks_started = True
            return
        os.makedirs(self.alloc_dir, exist_ok=True)
        # re-adopt a live driver-created network (the pause container
        # outlived the agent with its tasks): destroy() must tear it
        # down and restarted tasks must rejoin it, not the host net.
        # A transiently unreachable engine (boot ordering) is retried —
        # adopting None by mistake would silently split the group's
        # network AND leak the sandbox
        net_driver = self._group_network_driver(tg)
        net_env: Dict[str, str] = {}
        if net_driver is not None:
            spec = None
            for attempt in range(3):
                try:
                    spec = net_driver.recover_network(
                        self.alloc.id, self._port_mappings())
                    break
                except Exception as e:          # noqa: BLE001
                    LOG.warning("alloc %s: network recover attempt %d: %s",
                                self.alloc.id, attempt + 1, e)
                    time.sleep(1.0 + attempt)
            if spec is not None:
                self.driver_network = (net_driver, spec)
                if spec.ip:
                    net_env["NOMAD_ALLOC_IP"] = spec.ip
        for task in tg.tasks:
            driver = self.drivers.get(task.driver)
            if driver is None:
                continue
            try:
                device_env = self._reserve_devices(task.name)
            except Exception as e:              # noqa: BLE001
                LOG.warning("alloc %s: device reserve on restore: %s",
                            self.alloc.id, e)
                device_env = {}
            tr = TaskRunner(
                alloc=self.alloc,
                task=task,
                driver=driver,
                alloc_dir=self.alloc_dir,
                on_state_change=self._on_task_state,
                state_db=self.state_db,
                restart_policy=tg.restart_policy,
                extra_env=dict(device_env, **net_env),
                secrets=self.secrets,
                network_isolation=(self.driver_network[1]
                                   if self.driver_network else None),
            )
            local_state, handle = (None, None)
            if self.state_db is not None:
                local_state, handle = self.state_db.get_task_state(
                    self.alloc.id, task.name
                )
            recovered = tr.restore(local_state, handle)
            self.task_runners[task.name] = tr
            if recovered:
                # reattached to a live task: re-assert its service
                # registrations (deterministic ids make this an
                # idempotent upsert) so the dead-task path knows to
                # deregister later
                if self.service_reg is not None:
                    with self._lock:
                        first = not self._registered_tasks
                        self._registered_tasks.add(task.name)
                    if first:
                        self.service_reg.register(self.alloc, tg.services)
                    self.service_reg.register(self.alloc, task.services,
                                              task.name)
            elif local_state is None or local_state.state != STATE_DEAD:
                # task wasn't running anymore: start fresh
                tr.start()
        self._tasks_started = True
        self._watch_done()

    def _watch_done(self) -> None:
        self._waiter = threading.Thread(
            target=self._wait_all, daemon=True,
            name=f"alloc-{self.alloc.id[:8]}",
        )
        self._waiter.start()
        if self.alloc.deployment_id:
            threading.Thread(
                target=self._watch_health, daemon=True,
                name=f"health-{self.alloc.id[:8]}",
            ).start()

    def _watch_health(self) -> None:
        """Deployment health watcher (allocrunner allocHealthWatcher /
        health_hook.go): healthy once every task has been running
        continuously for min_healthy_time; unhealthy on task failure or
        the healthy deadline."""
        from nomad_tpu_torch.structs.alloc import AllocDeploymentStatus
        from nomad_tpu_torch.structs.job import UpdateStrategy

        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job is not None else None
        update = (tg.update if tg is not None and tg.update is not None
                  else UpdateStrategy())
        deadline = time.time() + update.healthy_deadline_s
        healthy_since = None
        while time.time() < deadline and not self._destroyed:
            with self._lock:
                states = dict(self.task_states)
            if states and any(s.state == STATE_DEAD and s.failed
                              for s in states.values()):
                self._report_health(False)
                return
            tasks = (len(tg.tasks) if tg is not None else 0) or 1
            all_running = (
                len(states) >= tasks
                and all(s.state == STATE_RUNNING for s in states.values())
            )
            if all_running:
                healthy_since = healthy_since or time.time()
                if time.time() - healthy_since >= update.min_healthy_time_s:
                    self._report_health(True)
                    return
            else:
                healthy_since = None
            time.sleep(0.05)
        if not self._destroyed:
            self._report_health(False)

    def _report_health(self, healthy: bool) -> None:
        from nomad_tpu_torch.structs.alloc import AllocDeploymentStatus

        updated = self.alloc.copy_skip_job()
        with self._lock:
            updated.task_states = dict(self.task_states)
        updated.client_status = self.client_status()
        updated.deployment_status = AllocDeploymentStatus(
            healthy=healthy, timestamp_ns=time.time_ns(),
        )
        self.on_alloc_update(updated)

    def _wait_all(self) -> None:
        for tr in list(self.task_runners.values()):
            tr.wait()

    # --- state aggregation (alloc_runner.go getClientStatus) ------------

    def _on_task_state(self, task_name: str, state: TaskState) -> None:
        # deep-copy at the boundary: the TaskRunner keeps mutating its
        # state object, and everything downstream (client batch, server
        # store, raft snapshot pickling) must own immutable rows
        state = copy.deepcopy(state)
        with self._lock:
            self.task_states[task_name] = state
            status, desc = self._client_status_locked()
        self._sync_services(task_name, state)
        updated = self.alloc.copy_skip_job()
        updated.client_status = status
        updated.client_description = desc
        updated.task_states = dict(self.task_states)
        self.on_alloc_update(updated)

    def _sync_services(self, task_name: str, state: TaskState) -> None:
        """Register a task's (and the group's) services when it starts
        running; pull everything when the alloc goes terminal
        (client/serviceregistration workload lifecycle)."""
        if self.service_reg is None:
            return
        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job is not None else None
        if tg is None:
            return
        if not tg.services and not any(t.services for t in tg.tasks):
            return
        if state.state == STATE_RUNNING:
            with self._lock:
                first = not self._registered_tasks
                fresh = task_name not in self._registered_tasks
                self._registered_tasks.add(task_name)
            if first:
                group_services = list(tg.services)
                if self.alloc_connect is not None:
                    # the sidecar's own registration is the mesh entry
                    # point other allocs' upstreams discover (the
                    # Consul sidecar service Nomad registers)
                    group_services += self.alloc_connect.sidecar_services
                self.service_reg.register(self.alloc, group_services)
            if fresh:
                task = tg.lookup_task(task_name)
                if task is not None:
                    self.service_reg.register(self.alloc, task.services,
                                              task_name)
        elif state.state == STATE_DEAD:
            with self._lock:
                terminal = all(s.state == STATE_DEAD
                               for s in self.task_states.values())
                was_registered = task_name in self._registered_tasks
                self._registered_tasks.discard(task_name)
            if terminal:
                # covers group services and any strays (also correct
                # after agent restart, where _registered_tasks was
                # rebuilt only from recovered tasks)
                self.service_reg.deregister_alloc(self.alloc.id)
            elif was_registered:
                # a dead task among live siblings pulls only its own
                # instances
                task = tg.lookup_task(task_name)
                if task is not None:
                    self.service_reg.deregister_task(
                        self.alloc, task.services, task_name
                    )

    def _client_status_locked(self) -> (str, str):
        states = list(self.task_states.values())
        if not states:
            return consts.ALLOC_CLIENT_PENDING, "no tasks have started"
        if any(s.state == STATE_RUNNING for s in states):
            return consts.ALLOC_CLIENT_RUNNING, "tasks are running"
        if all(s.state == STATE_DEAD for s in states):
            if any(s.failed for s in states):
                return consts.ALLOC_CLIENT_FAILED, "failed tasks"
            return consts.ALLOC_CLIENT_COMPLETE, "all tasks have completed"
        if any(s.state == STATE_DEAD and s.failed for s in states):
            return consts.ALLOC_CLIENT_FAILED, "failed tasks"
        return consts.ALLOC_CLIENT_PENDING, "no tasks have started"

    def client_status(self) -> str:
        with self._lock:
            return self._client_status_locked()[0]

    # --- filesystem + stats API (client fs_endpoint.go /
    #     alloc_endpoint.go surfaces) ------------------------------------

    def _safe_path(self, rel: str) -> str:
        """Confine API paths to the alloc dir (helper/escapingfs); task
        secrets dirs are never readable over the fs API
        (fs_endpoint.go denies SecretsDir)."""
        rel = rel.lstrip("/")
        full = os.path.realpath(os.path.join(self.alloc_dir, rel))
        root = os.path.realpath(self.alloc_dir)
        if not (full == root or full.startswith(root + os.sep)):
            raise PermissionError(f"path escapes allocation directory: {rel}")
        parts = os.path.relpath(full, root).split(os.sep)
        if "secrets" in parts:
            raise PermissionError("secrets directories are not accessible")
        return full

    def _reserve_devices(self, task_name: str):
        """devicemanager Reserve (device.proto Reserve -> container
        env/mounts): for each device the scheduler assigned to this
        task, ask the owning plugin how to expose it — e.g. the CUDA
        plugin returns CUDA_VISIBLE_DEVICES. Raises when a reservation
        fails: starting the task anyway would let the workload see
        devices reserved by other allocs (device_hook prestart fails
        the task in the reference)."""
        env = {}
        ar = self.alloc.allocated_resources
        if ar is None or not self.device_plugins:
            return env
        task_res = ar.tasks.get(task_name)
        if task_res is None or not task_res.devices:
            return env
        # enumerate each plugin once (fingerprint can be expensive:
        # the CUDA plugin talks to the runtime)
        plugin_groups = []
        for plugin in self.device_plugins:
            try:
                plugin_groups.append((plugin, plugin.fingerprint()))
            except Exception:                   # noqa: BLE001
                continue
        for dev in task_res.devices:
            owner = next(
                (p for p, groups in plugin_groups
                 if any(g.vendor == dev.vendor and g.type == dev.type
                        and (not dev.name or g.name == dev.name)
                        for g in groups)),
                None,
            )
            if owner is None:
                raise RuntimeError(
                    f"no device plugin owns {dev.id_string()}")
            resp = owner.reserve(dev.device_ids)
            env.update(resp.container_res)
        return env

    def _await_previous(self, tg) -> None:
        """allocwatcher prevAllocWaiter: a replacement alloc
        (blue/green update, reschedule on the same node) must not start
        until its predecessor's tasks have stopped; sticky/migrate
        ephemeral disks then move the old alloc data dir over."""
        prev_id = self.alloc.previous_allocation
        if not prev_id or self.prev_lookup is None:
            return
        prev = self.prev_lookup(prev_id)
        if prev is None:
            return   # remote predecessor or already GC'd locally
        while not (prev._tasks_started and prev.is_done()) \
                and not self._destroyed and not self._stop_requested:
            time.sleep(0.05)
        if self._destroyed or self._stop_requested:
            return
        disk = getattr(tg, "ephemeral_disk", None)
        if disk is None or not (disk.sticky or disk.migrate):
            return
        src = os.path.join(prev.alloc_dir, "alloc")
        dst = os.path.join(self.alloc_dir, "alloc")
        if not os.path.isdir(src):
            return
        try:
            shutil.copytree(src, dst, dirs_exist_ok=True)
            LOG.info("alloc %s: migrated ephemeral disk from %s",
                     self.alloc.id[:8], prev_id[:8])
        except OSError as e:
            LOG.warning("alloc %s: disk migration failed: %s",
                        self.alloc.id[:8], e)

    def task_logs_bytes(self, task: str, logtype: str = "stdout",
                        offset: int = 0, limit: int = 0) -> bytes:
        """Raw read across the logmon rotation chain
        <task>.<type>.N in index order."""
        from nomad_tpu_torch.client.logmon import read_rotated

        base = self._safe_path(
            os.path.join("alloc", "logs", f"{task}.{logtype}")
        )
        return read_rotated(base, offset=offset, limit=limit)

    def task_logs(self, task: str, logtype: str = "stdout",
                  offset: int = 0, limit: int = 0) -> str:
        """fs_endpoint.go Logs (non-follow read)."""
        return self.task_logs_bytes(
            task, logtype, offset=offset, limit=limit
        ).decode(errors="replace")

    def list_dir(self, rel: str = "/") -> List[Dict]:
        """fs_endpoint.go List."""
        path = self._safe_path(rel)
        if not os.path.isdir(path):
            raise FileNotFoundError(rel)
        out = []
        for name in sorted(os.listdir(path)):
            st = os.stat(os.path.join(path, name))
            out.append({
                "Name": name,
                "IsDir": os.path.isdir(os.path.join(path, name)),
                "Size": st.st_size,
                "ModTime": st.st_mtime,
            })
        return out

    def stat_file(self, rel: str) -> Dict:
        """fs_endpoint.go Stat."""
        path = self._safe_path(rel)
        if not os.path.exists(path):
            raise FileNotFoundError(rel)
        st = os.stat(path)
        return {
            "Name": os.path.basename(path) or "/",
            "IsDir": os.path.isdir(path),
            "Size": st.st_size,
            "ModTime": st.st_mtime,
        }

    def cat_file(self, rel: str, offset: int = 0, limit: int = 0) -> bytes:
        """fs_endpoint.go Cat/ReadAt."""
        path = self._safe_path(rel)
        if os.path.isdir(path):
            raise IsADirectoryError(rel)
        with open(path, "rb") as f:
            if offset:
                f.seek(offset)
            return f.read(limit or -1)

    def stats(self) -> Dict:
        """Per-task resource usage (AllocStats / TaskStats)."""
        tasks = {}
        for name, tr in self.task_runners.items():
            try:
                tasks[name] = tr.driver.task_stats(tr.task_id)
            except Exception:                   # noqa: BLE001
                tasks[name] = {}
        return {"Tasks": tasks}

    def restart_tasks(self, task_name: str = "") -> None:
        """alloc_endpoint.go Restart: bounce task(s) in place."""
        if task_name and task_name not in self.task_runners:
            raise KeyError(f"unknown task {task_name}")
        for name, tr in self.task_runners.items():
            if task_name and name != task_name:
                continue
            tr.restart("restart requested by user")

    def signal_tasks(self, signal: str, task_name: str = "") -> None:
        """alloc_endpoint.go Signal."""
        if task_name and task_name not in self.task_runners:
            raise KeyError(f"unknown task {task_name}")
        for name, tr in self.task_runners.items():
            if task_name and name != task_name:
                continue
            try:
                tr.driver.signal_task(tr.task_id, signal)
            except Exception as e:              # noqa: BLE001
                LOG.warning("signal %s to %s: %s", signal, name, e)

    def exec_in_task(self, task_name: str, cmd: List[str],
                     timeout: float = 30.0) -> Dict:
        """alloc_endpoint.go Exec (non-interactive one-shot)."""
        tr = self.task_runners.get(task_name)
        if tr is None:
            raise KeyError(f"unknown task {task_name}")
        return tr.driver.exec_task(tr.task_id, cmd, timeout=timeout)

    def exec_stream_in_task(self, task_name: str, cmd: List[str],
                            tty: bool = False):
        """Interactive exec (alloc exec; driver.proto:79
        ExecTaskStreaming). Returns the driver's ExecStream."""
        tr = self.task_runners.get(task_name)
        if tr is None:
            raise KeyError(f"unknown task {task_name}")
        fn = getattr(tr.driver, "exec_task_streaming", None)
        if fn is None:
            raise NotImplementedError(
                f"driver {tr.task.driver} does not support interactive exec"
            )
        return fn(tr.task_id, cmd, tty=tty)

    # --- updates / teardown ---------------------------------------------

    def update(self, alloc: Allocation) -> None:
        """Server pushed a new alloc version (alloc_runner.go Update)."""
        self.alloc = alloc
        if alloc.server_terminal_status():
            self.stop("alloc stopped by server")

    def stop(self, reason: str = "") -> None:
        self._stop_requested = True
        for tr in self.task_runners.values():
            tr.kill(reason)

    def destroy(self) -> None:
        self.stop("alloc destroyed")
        for tr in self.task_runners.values():
            tr.wait(timeout=5)
            try:
                tr.driver.destroy_task(tr.task_id, force=True)
            except Exception:                   # noqa: BLE001
                pass
        # connect postrun: sidecar/upstream proxies die with the alloc
        if self.alloc_connect is not None:
            try:
                self.alloc_connect.destroy()
            except Exception:                   # noqa: BLE001
                pass
            self.alloc_connect = None
        # bridge-network postrun (network_hook.go Postrun)
        if self.network_manager is not None and self.alloc_network is not None:
            try:
                self.network_manager.destroy(self.alloc.id)
            except Exception:                   # noqa: BLE001
                pass
            self.alloc_network = None
        if self.driver_network is not None:
            drv, spec = self.driver_network
            try:
                drv.destroy_network(self.alloc.id, spec)
            except Exception:                   # noqa: BLE001
                pass
            self.driver_network = None
        else:
            # safety net: even when recover/setup never adopted a spec
            # (engine down during restore), a sandbox may exist for
            # this alloc — best-effort teardown by name so it cannot
            # leak past the alloc's life
            tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
                if self.alloc.job is not None else None
            drv = self._group_network_driver(tg) if tg is not None else None
            if drv is not None:
                try:
                    drv.destroy_network(self.alloc.id, None)
                except Exception:               # noqa: BLE001
                    pass
        # CSI postrun: unpublish this alloc's mounts (csi_hook.go
        # Postrun); the server-side watcher releases the claim itself
        if self.csi_manager is not None:
            for mount in self.csi_mounts.values():
                try:
                    self.csi_manager.unmount_volume(self.alloc.id, mount)
                except Exception as e:          # noqa: BLE001
                    LOG.warning("alloc %s: csi unmount: %s", self.alloc.id, e)
            self.csi_mounts.clear()
        self._destroyed = True
        if self.state_db is not None:
            self.state_db.delete_allocation(self.alloc.id)
        shutil.rmtree(self.alloc_dir, ignore_errors=True)

    def is_done(self) -> bool:
        return all(tr.is_done() for tr in self.task_runners.values())
