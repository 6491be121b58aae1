"""Eval-lifecycle tracing and latency histograms (own copies).

``trace`` (spans, disabled by default) and ``histogram`` (streaming
latency histograms) are the scheduler path's instrumentation. The kernel
profiler and the exporters are not part of the port yet.
"""
