"""K2's divide-free reject test (cluster_tracer.k2_reject, which
csrc/cluster_tracer.cu mirrors) against the exact barycentric test of the
twin: as a property over float32 values it never rejects a pair that the
exact test accepts, and on a far-field cache's own inputs it rejects every
padding lane and nearly every miss.  Also the twin's count of the clusters
each 128-ray batch walks.  Torch only.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")

from hypothesis import example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from compound_ray_tpu_torch import testing as ttesting  # noqa: E402
from compound_ray_tpu_torch.scene.eye_io import ommatidia_to_array  # noqa: E402
from compound_ray_tpu_torch.trace import cluster_tracer as CT  # noqa: E402


def _exact_accepts(w1, w2, den):
    """The twin's exact barycentric test on float32 tensors (t >= tmin
    comes after it, in the twin and in the kernel alike)."""
    inv = 1.0 / den
    u, v = w1 * inv, w2 * inv
    return (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)


_TINY = float(np.float32(2.0 ** -149))  # the least subnormal


def _near_boundary(u, den, nudge):
    """(w1, w2, den) for barycentrics u and 1 - u scaled by den, nudged by
    a few ulps' worth of `nudge`: pairs on the edge u + v = 1."""
    f = np.float32
    v = f(1.0) - f(u) + f(nudge) * f(2.0 ** -24)
    with np.errstate(over="ignore"):  # |den| near the float32 limit
        return (float(f(u) * f(den)), float(v * f(den)), float(f(den)))


@settings(max_examples=3000, deadline=None)
@given(st.tuples(*[st.floats(width=32) for _ in range(3)])
       | st.tuples(st.floats(0.0, 1.0, width=32),
                   st.floats(-(2.0 ** 127), 2.0 ** 127, width=32),
                   st.sampled_from([0.0, 1.0, -1.0, 2.0 ** -20])).map(
           lambda x: _near_boundary(*x)))
@example((0.0, 0.0, 0.0))  # an all-zero padding lane
@example((0.0, 0.0, -0.0))
@example((1.0, 1.0, 0.0))  # den = 0, u = v = +inf
@example((1.0, 1.0, -0.0))
@example((-_TINY, 0.5, 1e30))  # u rounds to -0: accepted
@example((_TINY, -_TINY, -1e30))
@example((_TINY, _TINY, _TINY))  # subnormal products
@example((-_TINY, -_TINY, -_TINY))
@example((0.25, 0.75, 1.0))  # u + v = 1 exactly
@example((-0.25, -0.75, -1.0))
@example((1.0, 0.0, float("inf")))  # inv = 0: u = v = 0 accepted
@example((1.0, 0.0, float("-inf")))
@example((float("nan"), 0.0, 1.0))
@example((0.0, 0.0, float("nan")))
def test_reject_rule_never_rejects_an_accepted_pair(vals):
    """k2_reject is sound: no pair that the exact test accepts is rejected.
    Drawn over all float32 values (signed zeros, subnormals, infinities,
    NaN) and over pairs built on the edge u + v = 1 at every scale of den;
    its first two conditions alone (k2_keep_first) hold for every accepted
    pair as well."""
    w1, w2, den = (torch.tensor([x], dtype=torch.float32) for x in vals)
    if _exact_accepts(w1, w2, den).item():
        assert not CT.k2_reject(w1, w2, den).item(), vals
        assert CT.k2_keep_first(w1, den).item(), vals
    if not CT.k2_keep_first(w1, den).item():
        assert CT.k2_reject(w1, w2, den).item(), vals


def _cache_inputs(all_far=True):
    scene = ttesting.make_big_scene(n_boxes=200, seed=11)
    omms = ommatidia_to_array(ttesting.make_sphere_eye(64, 4.0))
    return ttesting.cache_trace_inputs(
        scene, omms, np.array([0.0, 2.0, 0.0], np.float32), "cpu", 64,
        split="all" if all_far else "far")


def test_reject_rule_on_cache_inputs_rejects_padding_and_most_misses():
    """On the 64-wide cache of the 200-box scene (8 tiles of 256 rays, every
    cluster of each tile's shortlist): every all-zero padding lane is
    rejected, no accepted pair is, and the rule rejects over 99 % of the
    pairs the exact test rejects, so the divide runs on few pairs."""
    c = _cache_inputs()
    rg = c.kw["rb_size"]
    pad = (c.payload == 0).all(dim=1)  # (C, 128)
    assert pad.any(), "the scene must have padding lanes"
    n_exact = n_rule = n_pairs = 0
    for g in range(c.kw["ng"]):
        cnt = int(c.counts[g].clamp(0, c.kw["kmax"]))
        if cnt == 0:
            continue
        tri = c.payload[c.ids[g, :cnt].long()]  # (cnt, 16, 128)
        ray = c.rays[g * rg:(g + 1) * rg]  # (rg, 16)
        d6 = ray[:, :6]
        w1 = torch.einsum("rf,cfl->crl", d6, tri[:, 0:6])
        w2 = torch.einsum("rf,cfl->crl", d6, tri[:, 6:12])
        den = torch.einsum("rf,cfl->crl", ray[:, :3], tri[:, 12:15])
        ok = _exact_accepts(w1, w2, den)
        rej = CT.k2_reject(w1, w2, den)
        assert not (ok & rej).any()
        assert rej[pad[c.ids[g, :cnt].long()][:, None, :].expand_as(rej)].all()
        n_exact += int((~ok).sum())
        n_rule += int(rej.sum())
        n_pairs += ok.numel()
    assert n_pairs > 1_000_000 and n_exact < n_pairs
    share = n_rule / n_exact
    print(f"k2_reject rejects {n_rule} of the exact test's {n_exact} "
          f"rejects ({share:.6f}) over {n_pairs} pairs")
    assert share > 0.99


def _walked_from_below(c, ref):
    """Clusters each 128-ray batch must walk at least: the whole shortlist
    when one of its rays misses, else up to its last winner's entry."""
    ng, rg, kmax = c.kw["ng"], c.kw["rb_size"], c.kw["kmax"]
    nb = rg // CT.BATCH_RAYS
    out = np.zeros((ng, nb), np.int64)
    for g in range(ng):
        cnt = int(c.counts[g].clamp(0, kmax))
        ids = c.ids[g, :cnt].tolist()
        rows = ref[g * rg:(g + 1) * rg].reshape(nb, CT.BATCH_RAYS, -1)
        for b in range(nb):
            hit = torch.isfinite(rows[b, :, 0])
            if not bool(hit.all()):
                out[g, b] = cnt
            else:
                out[g, b] = 1 + max(ids.index(int(x))
                                    for x in rows[b, :, 3].tolist())
    return out


@pytest.mark.parametrize("all_far", [True, False])
def test_twin_counts_the_clusters_each_batch_walks(all_far):
    """Without the early exit every batch walks min(counts, kmax) clusters;
    with it, at least up to its last winner's shortlist entry (all of them
    when a ray misses) and at most all of them, and the results are those
    of the uncounted twin."""
    c = _cache_inputs(all_far)
    args = (c.counts, c.ids, c.dmin, c.payload, c.rays)
    nb = c.kw["rb_size"] // CT.BATCH_RAYS
    cnt = c.counts.clamp(0, c.kw["kmax"]).long()[:, None].expand(-1, nb)
    full, walked_full = CT._cluster_tracer_twin(*args, **c.kw,
                                                count_walked=True)
    assert torch.equal(walked_full, cnt)
    early, walked = CT._cluster_tracer_twin(*args, early_exit=True, **c.kw,
                                            count_walked=True)
    assert walked.shape == (c.kw["ng"], nb) and walked.dtype == torch.int64
    below = torch.as_tensor(_walked_from_below(c, early))
    assert (walked >= below).all() and (walked <= cnt).all()
    if all_far:
        assert walked.sum() < cnt.sum(), "the early exit must save clusters"
    assert torch.equal(early, CT.cluster_tracer_reference(
        *args, early_exit=True, **c.kw))
    assert CT._cluster_tracer_twin(*args, early_exit=True, **c.kw)[1] is None
    assert torch.equal(full, early) or not all_far
