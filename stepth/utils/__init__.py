"""Observability & persistence: tracing/profiling spans, accuracy/throughput
metrics, and checkpoint/restore (SURVEY.md §5)."""

from stepth.utils import checkpoint, metrics, supervisor, tracing  # noqa: F401
