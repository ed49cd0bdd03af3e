"""Model zoo: configured stereo estimators (dense / hierarchical /
hierarchical-sgm / sgm / parity backends)."""

from stepth.models.stereo import StereoModel, flagship  # noqa: F401
