"""Multi-device parallelism: mesh construction and tile-sharded matching with
halo exchange (greenfield; SURVEY.md §2.3, §5)."""

from stepth.parallel import mesh, sharded  # noqa: F401
