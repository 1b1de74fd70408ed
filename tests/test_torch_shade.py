"""The frame core's unlit shading and mean (run_shade_means) on the CPU.

Its twin, shade_means_reference, must give the means that the eager chain
it was moved from gave, bit for bit, on every branch: textured or not,
every triangle textured (tex_only), flat material colours or vertex
colours, each miss shader, the far-field cache alone and in the combined
texture-and-cache table, the sky split's compacted groups, several
ommatidia a group or one ommatidium in a padded ray block, and a stacked
burst.  _eager_means below is that chain as the frame core ran it before
the shading kernel, kept frozen here.  The kernel itself
(csrc/shade_means.cu) is held to the twin on the card in
tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

from compound_ray_tpu_torch import testing
from compound_ray_tpu_torch.eye import pipeline as P
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array
from compound_ray_tpu_torch.trace.shade import (
    miss_color_c,
    quad_bilinear_c,
    texture_quad_coords_c,
)


def _eager_means(out, dirs, kw, f):
    """(Np, F, 3) means of the frame core's eager unlit shading, as
    _trace_shade_angles computed them before csrc/shade_means.cu."""
    dx, dy, dz = dirs
    ng, g, rg_pad = kw["ng"], kw["g"], kw["rg_pad"]
    samples, frames = kw["samples"], kw["frames"]
    cache, textured = kw["cache"], kw["textured"]
    n_pad, rg = ng * g, g * samples
    t_f, cu_f, cv_f, texid_f, rgb_f = P.resolve_kernel_hits(
        out, kw["attr_table"], kw["tex_only"])

    def unpad(x):
        return x.reshape(ng, rg_pad)[:, :rg].reshape(n_pad, samples)

    t = unpad(t_f)
    group_live = torch.repeat_interleave(kw["row_counts"] > 0, g)[:, None]
    hit = (t < 1e30) & group_live
    if cache is not None:
        centre, d_far = kw["far_sphere"]
        (ox, oy, oz), tmin_w, _, _ = P._omm_world_origins(f.omms_p, f.pos,
                                                          f.ls)
        tt = t + tmin_w[:, None]
        px = torch.addcmul((ox - centre[0])[:, None], tt, dx)
        py = torch.addcmul((oy - centre[1])[:, None], tt, dy)
        pz = torch.addcmul((oz - centre[2])[:, None], tt, dz)
        r2 = torch.addcmul(torch.addcmul(px * px, py, py), pz, pz)
        hit = hit & (r2 <= d_far * d_far)
    if kw["tex_only"]:
        rr = gg = bb = torch.zeros_like(t)
    else:
        rr, gg, bb = (unpad(c) for c in rgb_f)
    if textured:
        texid = unpad(texid_f)
        tex_idx, tfx, tfy = texture_quad_coords_c(
            kw["scene_dev"], torch.clamp(texid.reshape(-1), min=0),
            unpad(cu_f).reshape(-1), unpad(cv_f).reshape(-1))
    if textured and cache is not None:
        ch, cw = kw["cache_shape"]
        c_idx, cfx, cfy = P._equirect_coords_c(
            ch, cw, dx.reshape(-1), dy.reshape(-1), dz.reshape(-1))
        sel_tex = (hit & (texid >= 0)).reshape(-1)
        idx = torch.where(sel_tex, tex_idx, cache.shape[0] - ch * cw + c_idx)
        qr, qg, qb = quad_bilinear_c(
            cache[idx], torch.where(sel_tex, tfx, cfx),
            torch.where(sel_tex, tfy, cfy))
        keep = hit & (texid < 0)
        rr = torch.where(keep, rr, qr.reshape(n_pad, samples))
        gg = torch.where(keep, gg, qg.reshape(n_pad, samples))
        bb = torch.where(keep, bb, qb.reshape(n_pad, samples))
    else:
        if textured:
            qr, qg, qb = quad_bilinear_c(kw["quad_table"][tex_idx], tfx, tfy)
            sel = (texid >= 0) & hit
            rr = torch.where(sel, qr.reshape(n_pad, samples), rr)
            gg = torch.where(sel, qg.reshape(n_pad, samples), gg)
            bb = torch.where(sel, qb.reshape(n_pad, samples), bb)
        if cache is not None:
            c_idx, cfx, cfy = P._equirect_coords_c(
                cache.shape[0], cache.shape[1], dx.reshape(-1),
                dy.reshape(-1), dz.reshape(-1))
            mr, mg, mb = quad_bilinear_c(cache.reshape(-1, 16)[c_idx], cfx,
                                         cfy)
        else:
            mr, mg, mb = miss_color_c(dx.reshape(-1), dy.reshape(-1),
                                      dz.reshape(-1), kw["background"])
        rr = torch.where(hit, rr, mr.reshape(n_pad, samples))
        gg = torch.where(hit, gg, mg.reshape(n_pad, samples))
        bb = torch.where(hit, bb, mb.reshape(n_pad, samples))
    return torch.stack([c.reshape(n_pad, frames, samples // frames)
                        .mean(dim=2) for c in (rr, gg, bb)], dim=-1)


def _eye(n, deg):
    return ommatidia_to_array(testing.make_sphere_eye(n, deg))


# name -> (scene, eye, samples, pose, frame_pack keywords, frames)
CASES = {
    "textured-flat": (testing.make_mixed_flat_scene, (16, 6.0), 32,
                      (0.0, 5.0, 0.0), {}, 1),
    "tex-only-g1-320": (testing.make_two_texture_scene, (6, 8.0), 320,
                        (0.0, 5.0, 0.0), {}, 1),
    "flat-white": (lambda: testing.make_box_scene("white", colored=False),
                   (16, 6.0), 16, (0.0, 2.0, 3.0), {}, 1),
    "vertex-default-bg": (
        lambda: testing.make_box_scene("default_background"), (16, 6.0), 16,
        (0.0, 2.0, 3.0), {}, 1),
    "vertex-simple-sky": (testing.make_box_scene, (16, 6.0), 64,
                          (0.0, 2.0, 3.0), {}, 1),
    "burst-4": (testing.make_mixed_flat_scene, (16, 6.0), 16,
                (0.0, 5.0, 0.0), {}, 4),
    "cache": (lambda: testing.make_big_scene(200, seed=11), (64, 4.0), 128,
              (0.0, 2.0, 0.0), {"cache_width": 64}, 1),
    "cache-textured": (
        lambda: testing.add_textured_quads(testing.make_big_scene(200,
                                                                  seed=11)),
        (64, 4.0), 128, (0.0, 2.0, 0.0), {"cache_width": 64}, 1),
    "cache-sky": (lambda: testing.make_big_scene(200, seed=11), (64, 4.0),
                  128, (0.0, 2.0, 0.0), {"cache_width": 64, "sky": True}, 1),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    make, (n, deg), samples, pos, extra, frames = CASES[name]
    scene = make()
    f = testing.frame_pack(scene, _eye(n, deg), samples, pos, "cpu", seed=3,
                           **extra)
    return scene, f, testing.shade_inputs(scene, f, frames=frames)


@pytest.mark.parametrize("name", list(CASES))
def test_twin_equals_the_eager_chain(name):
    """shade_means_reference on a frame's K1 rows and rays equals the
    eager chain it replaced, bit for bit, and the frame shows what the
    case is about (hits and misses, textures, the cache's lookups)."""
    scene, f, (out, rays, dirs, kw) = _case(name)
    got = P.shade_means_reference(out, rays, **kw)
    want = _eager_means(out, dirs, kw, f)
    assert got.shape == (kw["ng"] * kw["g"], kw["frames"], 3)
    assert torch.equal(got, want)
    t = out[0].reshape(kw["ng"], kw["rg_pad"])[:, :kw["g"] * kw["samples"]]
    assert torch.isfinite(t).any() and not torch.isfinite(t).all()
    if name == "tex-only-g1-320":
        assert (kw["g"], kw["rg_pad"], kw["tex_only"]) == (1, 512, True)
    if name == "burst-4":  # each frame its own mean
        assert not torch.equal(got[:, 0], got[:, 1])
    if name == "cache-sky":
        assert f.sky_means is not None


@pytest.mark.parametrize("name", ["textured-flat", "cache-textured"])
def test_frame_core_takes_the_shader(name):
    """An unlit means frame shades through `shader` (run_shade_means by
    default, which on the CPU is the twin); lit frames and raw samples
    never call it."""
    scene, f, (out, rays, dirs, kw) = _case(name)
    calls = []

    def shader(*args, **kwargs):
        calls.append(kwargs["frames"])
        return P.run_shade_means(*args, **kwargs)

    ep = f.eplan
    args = dict(packed_mm=f.packed_mm, row_counts=f.row_counts,
                attr_table=f.splan.attr_table, scene_dev=kw["scene_dev"],
                quad_table=f.splan.quad_table, omms_p=f.omms_p,
                position=f.pos, local_space=f.ls, splay=f.splay,
                spin=f.spin, samples=f.samples,
                background=kw["background"], ng=f.ng, g=ep.g, nrb=ep.nrb,
                rb_size=ep.rb_size, rmax=f.rmax, textured=f.splan.textured,
                tex_only=f.splan.tex_only, cache=f.cache,
                cache_shape=f.cache_shape, far_sphere=f.far_sphere)
    means = P._trace_shade_angles(shader=shader, **args)
    assert calls == [1]
    assert torch.equal(means, P.shade_means_reference(out, rays, **kw)[:, 0])
    P._trace_shade_angles(shader=shader, want_samples=True, **args)
    assert calls == [1]


def test_wrapper_takes_the_twin_on_the_cpu_and_refuses_other_devices():
    """run_shade_means on CPU tensors is the twin and launches nothing; a
    device that is neither CPU nor CUDA is refused."""
    _, _, (out, rays, _, kw) = _case("textured-flat")
    before = P.shade_launches
    got = P.run_shade_means(out, rays, **kw)
    assert P.shade_launches == before
    assert torch.equal(got, P.shade_means_reference(out, rays, **kw))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        P.run_shade_means(out.to("meta"), rays.to("meta"), **kw)
