from stepth.core import io
from stepth.core.frame import MASK_FALSE, MASK_TRUE, DepthFrame, MaskFrame

__all__ = ["io", "DepthFrame", "MaskFrame", "MASK_TRUE", "MASK_FALSE"]
