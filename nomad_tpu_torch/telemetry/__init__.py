"""Eval-lifecycle tracing, latency histograms and the kernel profiler.

``trace`` (spans, disabled by default) and ``histogram`` (streaming
latency histograms) are own copies of the JAX package's modules;
``kernel_profile`` splits each placement launch into h2d, first launch
or dispatch, and execute, and meters the bytes a wave moves. ``enable``
and ``disable`` drive the tracer and the profiler together; ``reset``
zeroes both with the wave and device-state counters of the same window.
The exporters are not part of the port.
"""

from __future__ import annotations

from nomad_tpu_torch.telemetry.histogram import (  # noqa: F401
    HistogramRegistry,
    LatencyHistogram,
    histograms,
    percentile,
)
from nomad_tpu_torch.telemetry.kernel_profile import (  # noqa: F401
    KernelProfiler,
    profiler,
)
from nomad_tpu_torch.telemetry.trace import (  # noqa: F401
    ConsensusRecorder,
    FlightRecorder,
    Span,
    Tracer,
    consensus_recorder,
    flight_recorder,
    tracer,
)

__all__ = [
    "Span", "Tracer", "tracer",
    "KernelProfiler", "profiler",
    "LatencyHistogram", "HistogramRegistry", "histograms", "percentile",
    "FlightRecorder", "flight_recorder",
    "ConsensusRecorder", "consensus_recorder",
    "enable", "disable", "enabled", "reset",
]


def enable() -> None:
    tracer.enable()
    profiler.enable()


def disable() -> None:
    tracer.disable()
    profiler.disable()


def enabled() -> bool:
    return tracer.enabled


def reset() -> None:
    """Zero the counters of one measurement window: spans, the profiler
    (its keys seen stay), histograms, the recorders, the wave launcher's
    stats and the device state's stats (its resident planes stay)."""
    # imported here: both modules import telemetry.trace at load time
    from nomad_tpu_torch.parallel.coalesce import (
        fused_wave_stats,
        upload_stats,
        wave_stats,
    )
    from nomad_tpu_torch.tensors.device_state import default_device_state

    tracer.reset()
    profiler.reset()
    histograms.reset()
    flight_recorder.reset()
    consensus_recorder.reset()
    wave_stats.reset()
    fused_wave_stats.reset()
    upload_stats.reset()
    default_device_state.reset_stats()
