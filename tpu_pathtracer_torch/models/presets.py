"""Named material presets (counterpart of ``tpu_pathtracer/models/presets.py``)
— scene_materials.h:22–93 as material-table rows, the same values.

The reference hardcodes these as device functions (floor_coat_scatter :22,
floor_diffuse_scatter :30, floor_checker_scatter :35, model_coat_scatter
:46, model_diffuse_scatter :54, model_glossy_scatter :59,
model_glass_scatter :65, model_tintedglass_scatter :73, model_sss_scatter
:83). Here each is a row for :func:`make_materials`, so any scene can use
them by index.
"""

from __future__ import annotations

import math

from tpu_pathtracer_torch.models.scene import (
    CHECKER, COAT, DIFFUSE, GLASS, METAL, SSS_DIELECTRIC)

_MODEL_BASE = (0.0972942, 0.0482054, 0.000273194)  # scene_materials.h:50
_WHITE = (1.0, 1.0, 1.0)


def hex_color(hex_value: int) -> tuple:
    """scene_materials.h:6–11."""
    r = ((hex_value >> 16) & 0xFF) / 255.0
    g = ((hex_value >> 8) & 0xFF) / 255.0
    b = (hex_value & 0xFF) / 255.0
    return (r, g, b)


def floor_coat():
    """scene_materials.h:22–28: ior 1.5 coat over hex 0x511845 diffuse."""
    return dict(type=COAT, color=hex_color(0x511845), color2=_WHITE,
                param=1.5, param2=0.0)


def floor_diffuse():
    """scene_materials.h:30–33."""
    return dict(type=DIFFUSE, color=hex_color(0x511845))


def floor_checker():
    """scene_materials.h:35–44: frequency 0.2 checker of two hex colors."""
    return dict(type=CHECKER, color=hex_color(0x511845),
                color2=hex_color(0xFF5733), param=0.2)


def model_coat():
    """scene_materials.h:46–52: ior 1.1 coat over the model base color."""
    return dict(type=COAT, color=_MODEL_BASE, color2=_WHITE,
                param=1.1, param2=0.0)


def model_diffuse():
    """scene_materials.h:54–57."""
    return dict(type=DIFFUSE, color=_MODEL_BASE)


def model_glossy():
    """scene_materials.h:59–63: colorless mirror."""
    return dict(type=METAL, color=_WHITE, param=0.0)


def model_glass():
    """scene_materials.h:65–71: ior 1.1, no absorption."""
    return dict(type=GLASS, color=_WHITE, param=1.1)


def model_tinted_glass():
    """scene_materials.h:73–81: Beer–Lambert absorption
    -log(color)/distance with distance 10."""
    absorption = tuple(-math.log(c) / 10.0 for c in _MODEL_BASE)
    return dict(type=GLASS, color=_WHITE, param=1.1, absorption=absorption)


def model_sss():
    """scene_materials.h:83–93: ior 1.333 subsurface dielectric,
    absorption (0.9, 0.3, 0.02), scattering distance 2."""
    return dict(type=SSS_DIELECTRIC, color=_WHITE, color2=_WHITE,
                param=1.333, absorption=(0.9, 0.3, 0.02), scatter_dist=2.0)


ALL_PRESETS = {
    "floor_coat": floor_coat,
    "floor_diffuse": floor_diffuse,
    "floor_checker": floor_checker,
    "model_coat": model_coat,
    "model_diffuse": model_diffuse,
    "model_glossy": model_glossy,
    "model_glass": model_glass,
    "model_tinted_glass": model_tinted_glass,
    "model_sss": model_sss,
}
