"""Runtime configuration of the port (compound_ray_tpu/config.py, reduced).

Only the fields the port's render paths read are carried over.  The
environment names are the JAX package's (CR_TPU_*), so one shell setting
configures both packages.  Nothing here reads artifacts/tuning.json: those
adoptions were measured on a TPU and are not settings of this port.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_bool(s: str) -> bool:
    """compound_ray_tpu/config.py:26: the empty string and 0/false/off/no
    are false (case-insensitive), anything else is true."""
    return s.strip().lower() not in ("", "0", "false", "off", "no")


# backends the port renders with: "auto" (the kernels), "pallas" (its
# synonym, so one CR_TPU_BACKEND serves both packages) and "naive" (the
# brute-force oracle for every frame)
BACKENDS = ("auto", "pallas", "naive")


@dataclasses.dataclass
class RenderConfig:
    # backend (compound_ray_tpu/config.py:44-45): "auto" renders through the
    # kernels, "naive" through the brute-force oracle (trace/intersect.py)
    # for every frame, as the JAX package's last fallbacks do
    backend: str = "auto"
    # real-camera images of scenes below this many triangles take the
    # oracle, not the tile-culled K2 image (compound_ray_tpu/config.py:51)
    min_triangles_for_culling: int = 512
    # Gaussian truncation for cone culling, in standard deviations
    # (compound_ray_tpu/config.py:49).
    cull_sigmas: float = 4.0
    # base RNG seed (the reference's curand_init(42, ...), shaders.cu:689)
    base_seed: int = 42
    # far-field radiance cache (compound_ray_tpu/config.py:64-66): "auto"
    # renders the clusters beyond the parallax-safe distance once per pose
    # into an equirect cache from the eye centre (kernel K2) and lets the
    # per-sample rays trace only the near clusters; "off" traces every ray
    # against the whole scene.
    farfield: str = "auto"
    farfield_tolerance: float = 0.25
    farfield_cache_width: int = 1024  # equirect width; height = width // 2
    # bounded pose-keyed stores of packed payloads and sky plans
    # (ScenePlan.packed_store, ScenePlan.sky_store)
    packed_store_size: int = 4
    # the packed payloads' device bytes: a pack grows with the ommatidia,
    # so a pose batch (B poses folded into one eye) packs B eyes at once
    packed_store_bytes: int = 8 << 30
    # bounded (pose, lights, samples)-keyed store of lit-frame shadow plans
    # (ScenePlan.shadow_store, compound_ray_tpu/config.py:77)
    shadow_store_size: int = 4
    # level-2 refine test.  The port runs the exact cone-vs-triangle test
    # only; the JAX package's sphere-bounds-only "sphere" mode is not ported.
    refine_mode: str = "exact"
    # sky split (compound_ray_tpu/config.py:108-125): at a memoised cache
    # pose, compact the groups with near geometry and serve every zero-row
    # group its acceptance-cone expectation of the cache.  Statistically
    # interchangeable with the dense frame, not bit-identical to it.
    sky_split: bool = False
    # quadrature nodes of that expectation (splay quantiles x spin grid)
    sky_quad_splay: int = 16
    sky_quad_spin: int = 8
    # lit frames: the shadow-shaft audit's leak fraction at or above which
    # the leaking groups replan with guaranteed candidate-extent shadow
    # bounds (compound_ray_tpu/config.py:107); below it the leak only warns
    shadow_leak_tolerance: float = 2e-3
    # groups per chunk of the shadow plan's probe refine and per-light pack
    # (compound_ray_tpu/config.py:138): peak plan-time memory scales with it
    shadow_pack_chunk: int = 128

    def __post_init__(self):
        if self.backend == "xla":
            raise NotImplementedError(
                "backend='xla': the JAX package's culled XLA backend exists "
                "to give hosts without a TPU a fast path, and the port's "
                "kernels and their torch twins already run anywhere; use "
                "'auto' or 'naive'")
        if self.backend == "sharded":
            raise NotImplementedError(
                "backend='sharded': the multi-device path is not ported yet "
                "(ROADMAP.md queue 1, item 8); use 'auto' or 'naive'")
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend={self.backend!r}: expected one of {BACKENDS}")
        if self.farfield not in ("auto", "off"):
            raise ValueError(
                f"farfield={self.farfield!r}: expected 'auto' or 'off'")
        if self.refine_mode != "exact":
            raise NotImplementedError(
                f"refine_mode={self.refine_mode!r}: the port runs the exact "
                "cone-vs-triangle refine only")
        if self.packed_store_size < 1:
            raise ValueError("packed_store_size must be >= 1")
        if self.packed_store_bytes < 1:
            raise ValueError("packed_store_bytes must be >= 1")
        if self.shadow_store_size < 1:
            raise ValueError("shadow_store_size must be >= 1")
        if self.shadow_pack_chunk < 1:
            raise ValueError("shadow_pack_chunk must be >= 1")
        w = self.farfield_cache_width
        if w < 32 or w % 32:
            # 16x16 pixel blocks over a w x w/2 image (_render_cache)
            raise ValueError(
                f"farfield_cache_width={w} must be a positive multiple of 32")

    @classmethod
    def from_env(cls) -> "RenderConfig":
        mapping = {
            "CR_TPU_BACKEND": ("backend", str),
            "CR_TPU_MIN_TRIS_CULL": ("min_triangles_for_culling", int),
            "CR_TPU_CULL_SIGMAS": ("cull_sigmas", float),
            "CR_TPU_SEED": ("base_seed", int),
            "CR_TPU_FARFIELD": ("farfield", str),
            "CR_TPU_FARFIELD_TOL": ("farfield_tolerance", float),
            "CR_TPU_FARFIELD_WIDTH": ("farfield_cache_width", int),
            "CR_TPU_PACKED_STORE": ("packed_store_size", int),
            "CR_TPU_SHADOW_STORE": ("shadow_store_size", int),
            "CR_TPU_SHADOW_LEAK_TOL": ("shadow_leak_tolerance", float),
            "CR_TPU_SHADOW_CHUNK": ("shadow_pack_chunk", int),
            "CR_TPU_REFINE": ("refine_mode", str),
            "CR_TPU_SKY_SPLIT": ("sky_split", _env_bool),
            "CR_TPU_SKY_QUAD_SPLAY": ("sky_quad_splay", int),
            "CR_TPU_SKY_QUAD_SPIN": ("sky_quad_spin", int),
        }
        kwargs = {}
        for env, (name, typ) in mapping.items():
            raw = os.environ.get(env)
            if not raw:
                continue  # absent or empty (`CR_TPU_X= cmd` means "unset")
            try:
                kwargs[name] = typ(raw)
            except ValueError:
                raise ValueError(
                    f"{env}={raw!r} is not a valid {typ.__name__}") from None
        return cls(**kwargs)


_global_config: Optional[RenderConfig] = None


def get_config() -> RenderConfig:
    global _global_config
    if _global_config is None:
        _global_config = RenderConfig.from_env()
    return _global_config


def set_config(cfg: RenderConfig) -> None:
    global _global_config
    _global_config = cfg
