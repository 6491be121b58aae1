"""docklog: detached engine-log follower for docker tasks.

Reference behavior: drivers/docker/docklog/docklog.go — a separate
process follows the container's log stream from the ENGINE and writes
it into the task's log files, so task output keeps flowing across
agent restarts and does not depend on the `docker run` CLI attachment
staying alive. The agent records the docklog pid in the task handle
and reaps/respawns it on recover.

Run standalone:
  python -S docklog.py <socket> <container> <stdout_file> <stderr_file> [since]

``since`` (unix seconds) bounds the follow so a respawned follower
does not re-append history.

Appends to the files (rotation is the logmon collector's job when the
files are its FIFOs; plain files otherwise). Exits when the engine
closes the stream (container gone).
"""

import sys


def follow(socket_path: str, container: str,
           stdout_path: str, stderr_path: str, since: str = "0") -> int:
    # import here so the module is importable without the package when
    # run with -S from an arbitrary cwd
    sys.path.insert(0, __file__.rsplit("/", 3)[0])
    from nomad_tpu_torch.drivers.docker_api import DockerEngine, EngineError

    engine = DockerEngine(socket_path)
    try:
        with open(stdout_path, "ab", buffering=0) as out, \
                open(stderr_path, "ab", buffering=0) as err:
            for stream, data in engine.logs(container, follow=True,
                                            since=int(since or 0)):
                (err if stream == 2 else out).write(data)
    except (OSError, EngineError):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(follow(*sys.argv[1:6]))
