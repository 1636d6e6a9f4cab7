"""Image-texture sampling from a padded atlas stack (counterpart of
``tpu_pathtracer/ops/texture.py``).

All K textures live in one ``[K, Hmax, Wmax, 3]`` padded stack with
per-texture true sizes, so a batch of lookups is one gather. The atlas
is built on the host in numpy, exactly as the JAX package builds it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def build_atlas(images: List[np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack float32 HxWx3 images into a padded stack.

    Returns (atlas [K,Hmax,Wmax,3], widths [K], heights [K]).
    """
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    k = len(images)
    atlas = np.zeros((k, hmax, wmax, 3), np.float32)
    widths = np.zeros((k,), np.int32)
    heights = np.zeros((k,), np.int32)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        atlas[i, :h, :w] = im[..., :3]
        widths[i] = w
        heights[i] = h
    return atlas, widths, heights


def fetch(atlas: torch.Tensor, widths: torch.Tensor, heights: torch.Tensor,
          tex_id: torch.Tensor, tu: torch.Tensor,
          tv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor wrap-addressed texel fetch (kernels.cu:460–472),
    ``[N, 3]``. Lanes with tex_id < 0 read texture 0; the caller masks
    them (the ``mat.texId != -1`` guard at kernels.cu:458)."""
    tid = torch.clamp_min(tex_id, 0).to(torch.int64)
    w = widths[tid]
    h = heights[tid]
    # wrap: tu - floor(tu), kernels.cu:462–465
    fu = tu - torch.floor(tu)
    fv = tv - torch.floor(tv)
    # float -> int32 truncates toward zero, as the JAX astype does
    tx = ((w - 1).to(torch.float32) * fu).to(torch.int32)
    ty = ((h - 1).to(torch.float32) * fv).to(torch.int32)
    return atlas[tid, ty.to(torch.int64), tx.to(torch.int64)]


def load_texture(path: str) -> np.ndarray:
    """Load an image file to float32 HxWx3 in [0,1], vertically flipped —
    stbi_set_flip_vertically_on_load(true) + forced 3 channels +
    byte/255 conversion (staircase_scene.h:103–118, :121). Needs PIL,
    imported here so the package imports without it."""
    from PIL import Image

    im = Image.open(path).convert("RGB")
    arr = np.asarray(im, np.float32) / 255.0
    return arr[::-1].copy()  # flip vertically


def checkerboard_texture(size: int = 64, cells: int = 8,
                         c0=(0.9, 0.9, 0.9),
                         c1=(0.2, 0.2, 0.2)) -> np.ndarray:
    """Procedural stand-in texture (the staircase PNG assets are not
    shipped with the reference — staircase_scene.h:122 points at absolute
    local paths)."""
    y, x = np.mgrid[0:size, 0:size]
    parity = ((x * cells // size) + (y * cells // size)) % 2
    out = np.where(parity[..., None] == 0,
                   np.asarray(c0, np.float32), np.asarray(c1, np.float32))
    return out.astype(np.float32)
