"""Golden-image regression harness (the port's own copy of
``tpu_pathtracer/utils/golden.py``: importing any module of the JAX
package loads jax).

Reproduces the reference's only real test (SURVEY §4): a stored linear
``.ref`` image in ``REF_00.01`` format (main.cpp:24–60) compared by RMSE
over linear radiance (main.cpp:117–126), extended with SSIM (the
BASELINE.json acceptance metric).
"""

from __future__ import annotations

import struct

import numpy as np

REF_HEADER = b"REF_00.01\x00"


def save_reference(path: str, image: np.ndarray) -> None:
    """saveReference (main.cpp:25–33). ``image`` is [ny, nx, 3] float32."""
    ny, nx, _ = image.shape
    with open(path, "wb") as f:
        f.write(REF_HEADER)
        f.write(struct.pack("<ii", nx, ny))
        f.write(np.ascontiguousarray(image, np.float32).tobytes())


def load_reference(path: str, nx: int | None = None,
                   ny: int | None = None) -> np.ndarray:
    """loadReference (main.cpp:36–60) with the same header + dims check."""
    with open(path, "rb") as f:
        header = f.read(len(REF_HEADER))
        if header != REF_HEADER:
            raise ValueError(f"invalid header {header!r}")
        in_nx, in_ny = struct.unpack("<ii", f.read(8))
        if nx is not None and (in_nx != nx or in_ny != ny):
            raise ValueError(
                f"invalid nx, ny. Found {in_nx}, {in_ny}. Expected {nx}, {ny}")
        data = np.frombuffer(f.read(in_nx * in_ny * 12), np.float32)
    return data.reshape(in_ny, in_nx, 3).copy()


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """Linear-space RMSE exactly as main.cpp:117–126 (per-channel squared
    error averaged over channels, then over pixels, then sqrt)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = np.mean((a - b) ** 2, axis=-1)  # /3 over channels
    return float(np.sqrt(err.mean()))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float | None = None) -> float:
    """Mean SSIM over a luminance image pair (uniform 8×8 windows).

    Small self-contained implementation (no skimage in the image) of the
    standard SSIM formula; adequate as the BASELINE.json gate.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        w = np.array([0.2126, 0.7152, 0.0722])
        a = a @ w
        b = b @ w
    if a.ndim != 2 or min(a.shape) < 8:
        # a flat [npixels, 3] framebuffer silently yields empty 8x8
        # windows (nan) — demand a spatial image
        raise ValueError(f"ssim needs a [ny, nx(, 3)] image >= 8px a "
                         f"side, got {a.shape}")
    if data_range is None:
        data_range = max(a.max() - a.min(), b.max() - b.min(), 1e-12)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def box(x, k=8):
        """mean filter via cumulative sums, stride 1, valid windows."""
        c = np.cumsum(np.cumsum(x, axis=0), axis=1)
        c = np.pad(c, ((1, 0), (1, 0)))
        return (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)

    mu_a = box(a)
    mu_b = box(b)
    var_a = box(a * a) - mu_a ** 2
    var_b = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2) /
         ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return float(s.mean())
