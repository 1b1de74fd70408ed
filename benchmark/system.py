"""The system under test: compound_ray_tpu_torch, driven through its public
entry points only (RenderConfig, EyeRenderer, CompoundEyeCamera and the
scene entry build_scene_from_arrays).  This is the one file of the
benchmark that imports the program."""

from __future__ import annotations

import numpy as np

from benchmark.scene import SceneArrays


def flat_scene(scene: SceneArrays, name: str):
    """The program's scene of the benchmark's arrays: the soup through
    build_scene_from_arrays, then the uv, material and texture tables set
    on it as the program's own textured test scenes set them."""
    from compound_ray_tpu_torch.scene.flat import build_scene_from_arrays

    fs = build_scene_from_arrays(
        scene.vertices, scene.faces, vertex_colors=scene.vertex_colors,
        background_shader=scene.background, name=name)
    if scene.uv is not None:
        fs.uv0, fs.uv1, fs.uv2 = (np.ascontiguousarray(scene.uv[:, i])
                                  for i in range(3))
        fs.has_uv = np.ones(scene.num_triangles, bool)
    if scene.mat_id is not None:
        m = len(scene.mat_color)
        fs.mat_id = scene.mat_id.astype(np.int32)
        fs.mat_base_color = scene.mat_color.astype(np.float32)
        fs.mat_tex = scene.mat_tex.astype(np.int32)
        fs.mat_metallic = np.zeros(m, np.float32)
        fs.mat_roughness = np.full(m, 0.5, np.float32)
        fs.mat_mr_tex = np.full(m, -1, np.int32)
        fs.mat_normal_tex = np.full(m, -1, np.int32)
    if scene.textures:
        sizes = [t.data.shape[0] * t.data.shape[1] for t in scene.textures]
        fs.tex_data = np.concatenate(
            [t.data.reshape(-1, 4) for t in scene.textures]).astype(
                np.float32)
        fs.tex_offset = np.cumsum([0] + sizes[:-1]).astype(np.int32)
        fs.tex_width = np.array([t.data.shape[1] for t in scene.textures],
                                np.int32)
        fs.tex_height = np.array([t.data.shape[0] for t in scene.textures],
                                 np.int32)
        fs.tex_wrap_s = np.array([t.wrap_s for t in scene.textures],
                                 np.int32)
        fs.tex_wrap_t = np.array([t.wrap_t for t in scene.textures],
                                 np.int32)
        fs.tex_filter = np.array([t.filter for t in scene.textures],
                                 np.int32)
    fs._device_cache = None
    return fs


class System:
    """One EyeRenderer with the cell's scene, eye, settings and loop."""

    def __init__(self, cfg: dict, traffic: dict, scene: SceneArrays,
                 omms: np.ndarray, seed: int, device):
        from compound_ray_tpu_torch.api.renderer import EyeRenderer
        from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
        from compound_ray_tpu_torch.config import RenderConfig, set_config

        set_config(RenderConfig(base_seed=seed, **cfg["render_config"]))
        r = EyeRenderer(verbose=False, device=device)
        r.scene = flat_scene(scene, cfg["scene"]["generator"])
        r.scene.cameras.append(
            CompoundEyeCamera("eye", cfg["projection"], []))
        r.goto_camera(len(r.scene.cameras) - 1)
        r.set_ommatidia(omms)
        r.set_current_eye_samples_per_ommatidium(traffic["samples"])
        if traffic.get("display"):
            # the speed test's render size: ommatidia x 1
            r.set_render_size(len(omms), 1)
        r.set_lighting(bool(traffic.get("lighting", False)))
        self.renderer = r
        self.frames = 0  # frames rendered: the eye's frame counter

    def view(self, pose=None) -> np.ndarray:
        """One frame (or, with a pose, one view: set the pose, render, read
        back): the (N, 3) per-ommatidium means on the host."""
        r = self.renderer
        if pose is not None:
            r.set_camera_pose(*pose)
        r.render_frame()
        self.frames += 1
        return r.get_camera_data()

    def close(self) -> None:
        self.renderer.stop()
        self.renderer = None
