"""Exact NumPy oracle of the reference semantics (the parity anchor;
SURVEY.md §7 step 2 and docs/SEMANTICS.md)."""

from stepth.oracle import kmeans, pipeline, resize, ring, subdivision

__all__ = ["kmeans", "pipeline", "resize", "ring", "subdivision"]
