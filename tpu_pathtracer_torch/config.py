"""Render configuration: the same fields, defaults and ``validate()`` as
``tpu_pathtracer.config.RenderConfig``, so one set of knobs drives both
packages.

The port reads the renderer knobs (resolution, samples, depth, epsilon,
roulette, shadow, use_bvh, textures, stats, chunking) and
``packet_threshold``. The remaining fields name
TPU kernel variants and schedules of the JAX package (packet-BVH
prefetch schemes, MXU leaf tests, sort keys, interpret mode). They are
accepted so a config carries across unchanged, and have no effect in
the port until the slice that ports their kernel (ROADMAP queue B).
"""

from __future__ import annotations

import dataclasses
import warnings


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs of the renderer.

    Attributes read by the port:
      nx, ny: image resolution.
      ns: samples per pixel.
      max_depth: bounce limit.
      epsilon: self-intersection t_min.
      russian_roulette, rr_start_bounce: roulette after bounce
        ``rr_start_bounce`` with survival probability max(attenuation).
      shadow: next-event estimation toward the sphere light (with it
        off, specular light hits add the light color).
      use_bvh: with it, a mesh takes the brute-force triangle kernel, or
        above ``packet_threshold`` triangle slots the BVH kernels; without
        it, the all-triangles oracle.
      textures: image textures of mesh materials.
      stats: collect the ray-accounting counters.
      rays_per_chunk: lane count of a chunk (plain engine) or of the
        regeneration pool (0 = auto).
      flush_window: must be >= 0. The JAX regen engine's one-hot flush
        window; the port flushes by an indexed write, which needs no
        window, so values > 0 give the same image.
      check_nans: count NaN radiance samples into Stats.nans (needs
        ``stats``).
      packet_threshold: the largest mesh (in triangle slots) the JAX
        package brute-forces with ``use_bvh``; the port brute-forces the
        same meshes and traces larger ones through a BVH.
      bvh4: a mesh above ``packet_threshold`` with SAH BVH4 tables takes
        the BVH4 kernels; without it, the heap BVH kernels.
    """

    nx: int = 640
    ny: int = 800
    ns: int = 256
    max_depth: int = 64
    epsilon: float = 0.01
    russian_roulette: bool = True
    rr_start_bounce: int = 3
    shadow: bool = True
    use_bvh: bool = True
    textures: bool = True
    stats: bool = False
    samples_per_batch: int = 0
    rays_per_chunk: int = 0
    flush_window: int = 0
    check_nans: bool = False
    # TPU kernel knobs of the JAX package: accepted, no effect yet
    # (packet_threshold, bvh4 and the unported knobs that raise excepted:
    # see engine/wavefront.py). sort_rays and shadow_sort keep no effect:
    # a per-ray CUDA walk gained nothing from the sort (ROADMAP A-12).
    interpret: bool = False
    force_feat_kernels: bool = False
    sort_rays: bool = True
    shadow_sort: str = "scatter"
    packet_threshold: int = 8192
    packet_width: int = 64
    mx_leaf: bool = False
    mx_passes: int = 3
    regroup: bool = False
    regroup_dense: int = 160
    bvh4: bool = True
    packet_packs: int = 1
    packet_split: bool = False
    oct: bool = False
    prefetch: bool = True
    bvh4_pf: bool = True
    pair_pf: bool = True
    bvh4_pair: bool = False
    bvh4_spec: bool = False
    packet_scratch: bool = True
    bvh4_scratch: bool = True
    leaf_cull: bool = False
    fast_math: bool = False

    @property
    def num_pixels(self) -> int:
        return self.nx * self.ny

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> list:
        """Knob combinations that would silently do nothing, as warning
        strings (the same checks as the JAX package). Invalid values
        raise in ``__post_init__`` instead."""
        w = []
        if self.packet_split and self.packet_packs <= 1:
            w.append("packet_split requires packet_packs > 1")
        if self.oct and self.packet_packs > 1:
            w.append("oct is ignored by the multi-packet kernels "
                     "(packet_packs > 1)")
        if self.oct and self.prefetch:
            w.append("oct disables the sibling-pair cluster prefetch; "
                     "prefetch=True is ignored where the oct step engages")
        if self.leaf_cull and self.prefetch:
            w.append("leaf_cull disables the sibling-pair cluster "
                     "prefetch; prefetch=True is ignored")
        if self.pair_pf and (self.leaf_cull or self.oct):
            w.append("pair_pf is disabled by leaf_cull/oct")
        if (self.bvh4_spec or self.bvh4_pair) and not self.bvh4_pf:
            w.append("bvh4_spec/bvh4_pair require bvh4_pf")
        if self.bvh4_spec and self.bvh4_pair:
            w.append("bvh4_pair takes precedence over bvh4_spec")
        if self.mx_leaf and self.regroup:
            w.append("mx_leaf takes dispatch precedence over regroup")
        if self.fast_math and (self.mx_leaf or self.regroup):
            w.append("fast_math only affects the heap packet kernels; "
                     "the mx_leaf / regroup paths ignore it")
        if self.regroup and self.regroup_dense >= 1024:
            w.append("regroup_dense is clamped to 1023")
        if self.check_nans and not self.stats:
            w.append("check_nans counts into Stats.nans, which is "
                     "only collected/reported when stats=True")
        if self.packet_width & (self.packet_width - 1):
            w.append("packet_width should be a power of two")
        return w

    def __post_init__(self):
        if self.flush_window < 0:
            raise ValueError(
                f"flush_window must be >= 0, got {self.flush_window}")
        for msg in self.validate():
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
