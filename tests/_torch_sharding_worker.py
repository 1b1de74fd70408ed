"""One gloo rank of the port's sharded-path tests, and the cases it renders.

    python tests/_torch_sharding_worker.py RANK WORLD STORE OUT

joins a gloo process group of WORLD ranks through the file:// store STORE,
renders the cases below through the public sharded functions on a (WORLD //
2, 2) mesh on the CPU, then EyeRenderer's sharded routes (backend "auto"),
and writes its results to OUT/rank<RANK>.npz.  tests/test_torch_sharding_ranks.py starts the ranks
and checks what they wrote; it imports the cases and combine_in_process
from here.  This file imports torch and the port only, never JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from compound_ray_tpu_torch import EyeRenderer
from compound_ray_tpu_torch.cameras.types import CompoundEyeCamera
from compound_ray_tpu_torch.eye.pipeline import eye_plan
from compound_ray_tpu_torch.eye.sampling import FWHM_SD_RATIO
from compound_ray_tpu_torch.parallel import sharding as S
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array
from compound_ray_tpu_torch.testing import (
    canopy_eye,
    make_big_scene,
    make_box_scene,
    make_canopy_scene,
    make_sphere_eye,
)
from compound_ray_tpu_torch.trace.lighting import default_lights
from compound_ray_tpu_torch.trace.shade import miss_id

LS = np.eye(3, dtype=np.float32)
BURST_SEEDS = (21, 22)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def unlit_case():
    """(scene, ommatidia, pose, samples, background) of
    tests/test_sharding.py:69 at 8 samples."""
    scene = make_big_scene(n_boxes=120, seed=6)
    omms = ommatidia_to_array(make_sphere_eye(48, acceptance_deg=5.0))
    return (scene, omms, np.array([1.0, 2.0, 3.0], np.float32), 8,
            miss_id(scene.background_shader))


def lit_case():
    """The canopy scene and its eye at 4 samples, with the default
    lights."""
    scene = make_canopy_scene()
    omms = ommatidia_to_array(canopy_eye(2.0))
    return (scene, omms, np.zeros(3, np.float32), 4, 2,
            default_lights(scene.aabb_min, scene.aabb_max))


def raw_case():
    """tests/test_sharding.py:160's scene and eye at 4 samples."""
    scene = make_big_scene(n_boxes=60, seed=2)
    omms = ommatidia_to_array(make_sphere_eye(32, acceptance_deg=1e-5))
    return (scene, omms, np.array([0.0, 2.0, 0.0], np.float32), 4,
            miss_id(scene.background_shader))


def numpy_angles(omms: np.ndarray, samples: int, omm_axis: int,
                 seed: int = 4):
    """Global (Np, S) splay and spin from numpy for the mesh plan's
    permuted eye."""
    omms_p = omms[eye_plan(omms, samples, ng_multiple=omm_axis).perm]
    sd = omms_p[:, 6] / FWHM_SD_RATIO
    rng = np.random.default_rng(seed)
    shape = (omms_p.shape[0], samples)
    return (torch.tensor((rng.standard_normal(shape)
                          * sd[:, None]).astype(np.float32)),
            torch.tensor((rng.uniform(size=shape) * np.pi)
                         .astype(np.float32)))


def combine_in_process(plan, shape, want_samples=False, angles=None):
    """Every shard of the plan in this process, combined as the two
    collectives would: the sum over the sample axis, then the omm axis's
    rows, the sky scatter and inv_valid; or for raw samples the (S, N, 3)
    buffer."""
    splay, spin = angles if angles is not None else (None, None)
    rows = []
    for i in range(shape["omm"]):
        parts = [S.shard_core(plan, i, j, splay, spin,
                              want_samples=want_samples)
                 for j in range(shape["sample"])]
        if want_samples:
            rows.append(torch.cat(parts, dim=1))
        else:
            rows.append(sum(parts[1:], parts[0]))
    out = torch.cat(rows)
    if want_samples:
        return out[plan.inv_valid].transpose(0, 1)
    kw = plan.kw
    if kw["sky_means"] is not None:
        out = S.scatter_sky(out, kw["sky_means"], kw["sky_scatter"])
    return out[plan.inv_valid]


def renderer(lighting: bool = False, raw: bool = False) -> EyeRenderer:
    """An EyeRenderer on the CPU with the 64-ommatidium eye of
    tests/test_pipelined_scan.py on the box scene, at 8 samples."""
    r = EyeRenderer(verbose=False, device="cpu")
    r.scene = make_box_scene()
    proj = "raw_ommatidial_samples" if raw else "spherical_positionwise"
    cam = CompoundEyeCamera("eye", proj, make_sphere_eye(64))
    cam.set_samples_per_ommatidium(8)
    r.scene.cameras.append(cam)
    r.goto_camera(len(r.scene.cameras) - 1)
    r.set_lighting(lighting)
    return r


def run_cases(mesh) -> dict:
    """Every case's result on this rank."""
    out = {}
    scene, omms, pos, samples, bg = unlit_case()
    dev = scene.device_triangles("cpu")
    out["unlit"] = S.render_means_sharded_packed(
        scene, dev, omms, pos, LS, _gen(9), samples, bg, mesh)
    out["frames"] = S.render_means_sharded_packed_frames(
        scene, dev, omms, pos, LS, [_gen(s) for s in BURST_SEEDS], samples,
        bg, mesh)
    out["frames_sequential"] = torch.stack([S.render_means_sharded_packed(
        scene, dev, omms, pos, LS, _gen(s), samples, bg, mesh)
        for s in BURST_SEEDS])
    out["angles"] = S.render_means_sharded_angles(
        scene, dev, omms, pos, LS,
        *numpy_angles(omms, samples, mesh.shape["omm"]), samples, bg, mesh)
    scene, omms, pos, samples, bg, lights = lit_case()
    out["lit"] = S.render_means_sharded_packed(
        scene, scene.device_triangles("cpu"), omms, pos, LS, _gen(5),
        samples, bg, mesh, lights=lights)
    scene, omms, pos, samples, bg = raw_case()
    out["raw"] = S.render_samples_sharded_packed(
        scene, scene.device_triangles("cpu"), omms, pos, LS, _gen(11),
        samples, bg, mesh)
    return out


def run_renderer() -> dict:
    """EyeRenderer's sharded routes: two render_frame() calls against a
    two-frame render_frames_pipelined, unlit and lit, and raw samples; with
    the routes taken (the two bursts', then the raw frame's)."""
    out, routes = {}, []
    for lit in (False, True):
        tag = "lit" if lit else "unlit"
        seq = renderer(lighting=lit)
        routes.append(seq._burst_route())
        for _ in range(2):
            seq.render_frame()
        out[f"renderer_{tag}_frames"] = seq.get_camera_data()
        burst = renderer(lighting=lit)
        burst.render_frames_pipelined(2)
        out[f"renderer_{tag}_burst"] = burst.get_camera_data()
    raw = renderer(raw=True)
    routes.append("sharded" if raw._sharded() else "not sharded")
    raw.render_frame()
    out["renderer_raw"] = raw._raw_samples
    out["renderer_raw_means"] = raw.get_camera_data()
    out["routes"] = np.array([str(x) for x in routes])
    return out


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = S.make_eye_mesh(sample_parallel=2, device="cpu")
        res = dict(run_cases(mesh), **run_renderer())
        res["coords"] = np.array(mesh.coords)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: (v.numpy() if torch.is_tensor(v) else v)
                    for k, v in res.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
