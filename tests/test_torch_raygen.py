"""The frame core's ray generation (run_ray_features) on the CPU.

Its twin, ray_features_reference, must give the rays, directions and
origins that the eager chain it was moved from gave, bit for bit, on every
branch: one ommatidium per group with and without block padding, several
ommatidia a group, several ray blocks a group, a stacked burst's F x S
columns, a sharded frame's strided columns, and axes whose perp
degenerates (along +-y, and the reference's sum(perp) == 0 quirk), each
in the 16- and the 8-feature form.  _eager_* below is that chain as the
frame core ran it before csrc/ray_features.cu, kept frozen here.  The
kernel itself is held to the twin on the card in tests/test_torch_cuda.py.
"""

import pytest
import torch
import torch.nn.functional as F

from compound_ray_tpu_torch import testing
from compound_ray_tpu_torch.eye import pipeline as P
from compound_ray_tpu_torch.eye.sampling import cone_offset_components
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array
from compound_ray_tpu_torch.trace.lighting import default_lights
from compound_ray_tpu_torch.trace.mm_tracer import RAY_FEATS, RAY_FEATS_AFFINE
from compound_ray_tpu_torch.trace.shade import miss_id


def _eager_origins(omms_p, position, local_space):
    ax, ay, az = omms_p[:, 3], omms_p[:, 4], omms_p[:, 5]
    axis_len = torch.sqrt(ax * ax + ay * ay + az * az)
    inv_al = 1.0 / torch.clamp(axis_len, min=1e-30)
    focal = omms_p[:, 7]
    rx = omms_p[:, 0] - ax * inv_al * focal
    ry = omms_p[:, 1] - ay * inv_al * focal
    rz = omms_p[:, 2] - az * inv_al * focal
    L = local_space
    ox = position[0] + rx * L[0, 0] + ry * L[1, 0] + rz * L[2, 0]
    oy = position[1] + rx * L[0, 1] + ry * L[1, 1] + rz * L[2, 1]
    oz = position[2] + rx * L[0, 2] + ry * L[1, 2] + rz * L[2, 2]
    return (ox, oy, oz), focal * axis_len, (ax, ay, az), axis_len


def _eager_rays(omms_p, position, local_space, splay, spin, samples, ng, g,
                nrb, rb_size, affine):
    """(rays, (dx, dy, dz), origins) of the frame core's eager ray
    generation, as _trace_shade_angles made them before the kernel."""
    origins = _eager_origins(omms_p, position, local_space)
    (ox, oy, oz), tmin_w, (ax, ay, az), _ = origins
    L = local_space
    rdx, rdy, rdz = cone_offset_components(
        ax[:, None], ay[:, None], az[:, None], splay, spin)
    wdx = rdx * L[0, 0] + rdy * L[1, 0] + rdz * L[2, 0]
    wdy = rdx * L[0, 1] + rdy * L[1, 1] + rdz * L[2, 1]
    wdz = rdx * L[0, 2] + rdy * L[1, 2] + rdz * L[2, 2]
    inv_n = torch.rsqrt(torch.clamp(wdx * wdx + wdy * wdy + wdz * wdz,
                                    min=1e-60))
    dx, dy, dz = wdx * inv_n, wdy * inv_n, wdz * inv_n
    ones = torch.ones_like(dx)
    zeros = torch.zeros_like(dx)
    if affine:
        comps = [dx, dy, dz, ones]
        n_feats = RAY_FEATS_AFFINE
    else:
        tmin = tmin_w[:, None]
        oxb, oyb, ozb = ox[:, None], oy[:, None], oz[:, None]
        mx = oyb * dz - ozb * dy
        my = ozb * dx - oxb * dz
        mz = oxb * dy - oyb * dx
        comps = [dx, dy, dz, mx, my, mz, -(oxb + tmin * dx),
                 -(oyb + tmin * dy), -(ozb + tmin * dz), ones]
        n_feats = RAY_FEATS
    comps += [zeros] * (n_feats - len(comps))
    rg = g * samples
    rg_pad = nrb * rb_size
    rays = torch.stack([c.reshape(ng, rg) for c in comps])
    if rg_pad != rg:
        rays = F.pad(rays, (0, rg_pad - rg), mode="replicate")
    return rays.reshape(n_feats, ng * rg_pad), (dx, dy, dz), origins


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("name", list(testing.RAYGEN_CASES))
def test_twin_equals_the_eager_chain(name, affine):
    """ray_features_reference's rays, their direction planes (ray_dirs)
    and its origins equal the eager chain's bit for bit, and the padding
    slots repeat each group's last real ray."""
    kw = testing.raygen_inputs(name, "cpu")
    rays, ((ox, oy, oz), tmin) = P.ray_features_reference(**kw,
                                                          affine=affine)
    want, dirs, ((wx, wy, wz), wt, _, _) = _eager_rays(**kw, affine=affine)
    assert rays.shape == (RAY_FEATS_AFFINE if affine else RAY_FEATS,
                          kw["ng"] * kw["nrb"] * kw["rb_size"])
    assert torch.equal(rays, want)
    got_dirs = P.ray_dirs(rays, kw["ng"], kw["g"], kw["samples"],
                          kw["nrb"] * kw["rb_size"])
    for a, b in zip(got_dirs, dirs):
        assert torch.equal(a, b)
    for a, b in ((ox, wx), (oy, wy), (oz, wz), (tmin, wt)):
        assert torch.equal(a, b)
    rg, rg_pad = kw["g"] * kw["samples"], kw["nrb"] * kw["rb_size"]
    blocks = rays.reshape(rays.shape[0], kw["ng"], rg_pad)
    assert torch.equal(blocks[:, :, rg:],
                       blocks[:, :, rg - 1:rg].expand_as(blocks[:, :, rg:]))
    assert torch.isfinite(rays).all()
    if name == "degenerate-axes":  # perp = +z: these rays are unit too
        norm = dirs[0] ** 2 + dirs[1] ** 2 + dirs[2] ** 2
        assert torch.allclose(norm, torch.ones_like(norm), atol=1e-5)


def test_wrapper_takes_the_twin_on_the_cpu_and_refuses_other_devices():
    """run_ray_features on CPU tensors is the twin and launches nothing; a
    device that is neither CPU nor CUDA is refused."""
    kw = testing.raygen_inputs("g2-s100", "cpu")
    before = P.raygen_launches
    rays, origins = P.run_ray_features(**kw)
    assert P.raygen_launches == before
    want, want_o = P.ray_features_reference(**kw)
    assert torch.equal(rays, want)
    assert all(torch.equal(a, b) for a, b in zip((*origins[0], origins[1]),
                                                 (*want_o[0], want_o[1])))
    meta = dict(kw, **{k: kw[k].to("meta") for k in
                       ("omms_p", "position", "local_space", "splay",
                        "spin")})
    with pytest.raises(ValueError, match="CPU or CUDA"):
        P.run_ray_features(**meta)


def test_frame_core_generates_its_rays_once():
    """Every frame core, unlit means, raw samples and lit, makes its rays
    in one run_ray_features call; its means are those of the rays the
    eager chain made."""
    scene = testing.make_mixed_flat_scene()
    omms = ommatidia_to_array(testing.make_sphere_eye(16, 6.0))
    f = testing.frame_pack(scene, omms, 32, (0.0, 5.0, 0.0), "cpu", seed=3)
    ep = f.eplan
    args = dict(packed_mm=f.packed_mm, row_counts=f.row_counts,
                attr_table=f.splan.attr_table,
                scene_dev=scene.device_triangles("cpu"),
                quad_table=f.splan.quad_table, omms_p=f.omms_p,
                position=f.pos, local_space=f.ls, splay=f.splay,
                spin=f.spin, samples=f.samples,
                background=miss_id(scene.background_shader), ng=f.ng,
                g=ep.g, nrb=ep.nrb, rb_size=ep.rb_size, rmax=f.rmax,
                textured=f.splan.textured, tex_only=f.splan.tex_only)
    calls = []
    run = P.run_ray_features

    def record(*a, **k):
        calls.append(k["samples"])
        return run(*a, **k)

    P.run_ray_features = record
    try:
        means = P._trace_shade_angles(**args)
        assert calls == [f.samples]
        raw = P._trace_shade_angles(want_samples=True, **args)
        assert calls == [f.samples] * 2
        # a lit frame: the shadow plan's probe, then the frame core
        testing.lit_frame_means(
            scene, f, default_lights(scene.aabb_min, scene.aabb_max))
        assert calls == [f.samples] * 4
    finally:
        P.run_ray_features = run
    assert raw.shape == (f.omms_p.shape[0], f.samples, 3)
    rays, dirs, origins = _eager_rays(
        f.omms_p, f.pos, f.ls, f.splay, f.spin, f.samples, f.ng, ep.g,
        ep.nrb, ep.rb_size, False)
    out = P.run_packed_tracer(f.row_counts, f.packed_mm, rays, ng=f.ng,
                              nrb=ep.nrb, rb_size=ep.rb_size, rmax=f.rmax)
    planes = P._shade_planes(
        out, *dirs, f.row_counts, f.splan.attr_table, args["scene_dev"],
        f.splan.quad_table, origins, args["background"], f.ng, ep.g,
        ep.nrb * ep.rb_size, f.samples, f.splan.textured,
        f.splan.tex_only)[:3]
    assert torch.equal(means, P._plane_means(planes, 1)[:, 0])
