"""Telemetry: in-memory metrics registry with prometheus exposition.

Reference behavior: armon/go-metrics with inmem + prometheus sinks
(command/agent/command.go:1044 setupTelemetry; /v1/metrics
http.go:383). Counters, gauges, and sample timers (with p50/p95/max
aggregation over a sliding window), labeled, concurrency-safe.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Optional[Dict[str, str]]) -> _Key:
    return name, tuple(sorted((labels or {}).items()))


class MetricsRegistry:
    def __init__(self, window_s: float = 60.0) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._samples: Dict[_Key, deque] = {}
        self.window_s = window_s

    def incr_counter(self, name: str, value: float = 1.0,
                     labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def add_sample(self, name: str, value: float,
                   labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(name, labels)
        now = time.time()
        with self._lock:
            dq = self._samples.setdefault(k, deque(maxlen=4096))
            dq.append((now, value))

    def measure_since(self, name: str, start: float,
                      labels: Optional[Dict[str, str]] = None) -> None:
        self.add_sample(name, (time.time() - start) * 1000.0, labels)

    class _Timer:
        def __init__(self, reg: "MetricsRegistry", name: str, labels) -> None:
            self.reg, self.name, self.labels = reg, name, labels

        def __enter__(self):
            self.start = time.time()
            return self

        def __exit__(self, *exc):
            self.reg.measure_since(self.name, self.start, self.labels)

    def timer(self, name: str, labels: Optional[Dict[str, str]] = None):
        return self._Timer(self, name, labels)

    # -- exposition ------------------------------------------------------

    def _sample_stats(self, dq: deque) -> Dict[str, float]:
        cutoff = time.time() - self.window_s
        vals = sorted(v for t, v in dq if t >= cutoff)
        if not vals:
            return {"count": 0}
        n = len(vals)
        return {
            "count": n,
            "min": vals[0],
            "max": vals[-1],
            "mean": sum(vals) / n,
            "p50": vals[n // 2],
            "p95": vals[min(n - 1, int(n * 0.95))],
            "p99": vals[min(n - 1, int(n * 0.99))],
        }

    def summary(self) -> Dict:
        with self._lock:
            return {
                "Counters": [
                    {"Name": name, "Labels": dict(labels), "Count": v}
                    for (name, labels), v in sorted(self._counters.items())
                ],
                "Gauges": [
                    {"Name": name, "Labels": dict(labels), "Value": v}
                    for (name, labels), v in sorted(self._gauges.items())
                ],
                "Samples": [
                    {"Name": name, "Labels": dict(labels),
                     **self._sample_stats(dq)}
                    for (name, labels), dq in sorted(self._samples.items())
                ],
                "Timestamp": time.strftime("%Y-%m-%d %H:%M:%S +0000 UTC",
                                           time.gmtime()),
            }

    def prometheus_text(self) -> str:
        """Prometheus text exposition format."""

        def fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
            if not labels:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in labels)
            return "{" + inner + "}"

        def sanitize(name: str) -> str:
            return name.replace(".", "_").replace("-", "_")

        lines: List[str] = []
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                n = sanitize(name)
                lines.append(f"# TYPE {n} counter")
                lines.append(f"{n}{fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                n = sanitize(name)
                lines.append(f"# TYPE {n} gauge")
                lines.append(f"{n}{fmt_labels(labels)} {v}")
            for (name, labels), dq in sorted(self._samples.items()):
                n = sanitize(name)
                stats = self._sample_stats(dq)
                if not stats.get("count"):
                    continue
                lines.append(f"# TYPE {n} summary")
                for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                    ql = labels + (("quantile", q),)
                    lines.append(f"{n}{fmt_labels(ql)} {stats[key]}")
                lines.append(f"{n}_count{fmt_labels(labels)} {stats['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._samples.clear()


global_registry = MetricsRegistry()
