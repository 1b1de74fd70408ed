from compound_ray_tpu_torch.accel.clusters import (
    ClusterSet,
    build_clusters,
    scene_clusters,
)

__all__ = ["ClusterSet", "build_clusters", "scene_clusters"]
