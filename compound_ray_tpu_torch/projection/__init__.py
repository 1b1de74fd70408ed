from compound_ray_tpu_torch.projection.project import (
    PROJECTIONS,
    decode_projection_map_id,
    project_frame,
    voronoi_index_map,
)

__all__ = [
    "PROJECTIONS",
    "project_frame",
    "voronoi_index_map",
    "decode_projection_map_id",
]
