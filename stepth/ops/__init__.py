from stepth.ops import adjust, depth, kmeans, mask, photometric, resize, temporal

__all__ = ["adjust", "depth", "kmeans", "mask", "photometric", "resize", "temporal"]
