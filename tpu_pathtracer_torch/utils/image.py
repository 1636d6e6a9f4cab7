"""Image output: sRGB conversion, PPM and PNG writers (the port's own
copy of ``tpu_pathtracer/utils/image.py``).

Gamma happens only at write time; the framebuffer stays linear
(kernels.cu:564–568, staircase_scene.h:22–43).
"""

from __future__ import annotations

import numpy as np


def linear_to_srgb_u8(x: np.ndarray) -> np.ndarray:
    """The reference's sRGB approximation (staircase_scene.h:22–30):
    ``clamp(1.055 * x^(1/2.4) - 0.055)`` scaled by 255.9."""
    x = np.maximum(x, 0.0)
    x = np.maximum(1.055 * np.power(x, 0.416666667) - 0.055, 0.0)
    u = (x * 255.9).astype(np.uint32)
    return np.minimum(u, 255).astype(np.uint8)


def write_ppm(path: str, image: np.ndarray) -> None:
    """P3 PPM, rows written top-down from j = ny-1 (writePPM,
    staircase_scene.h:32–43). ``image`` is [ny, nx, 3] linear float with
    row j=0 at the image bottom."""
    ny, nx, _ = image.shape
    srgb = linear_to_srgb_u8(image)
    with open(path, "w") as f:
        f.write(f"P3\n{nx} {ny}\n255\n")
        for j in range(ny - 1, -1, -1):
            row = srgb[j]
            f.write("\n".join(f"{r} {g} {b}" for r, g, b in row))
            f.write("\n")


def write_png(path: str, image: np.ndarray) -> None:
    """PNG via PIL (replaces stb_image for output convenience)."""
    from PIL import Image

    srgb = linear_to_srgb_u8(image)
    Image.fromarray(srgb[::-1], "RGB").save(path)
