"""The port's camera against the JAX package's: the same basis and the
same primary rays for the thin-lens (random spheres) and pinhole
(three-sphere) cameras."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer.camera import make_camera as jmake
from tpu_pathtracer_torch.camera import Camera, make_camera as tmake

CAMERAS = {
    # (lookfrom, lookat, vup, vfov, aspect, aperture, focus_dist)
    "thin-lens": ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0,
                  1.5, 0.1, 10.0),
    "pinhole": ((0.0, 0.3, 1.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), 60.0,
                1.5, 0.0, None),
}
# float32 basis math in two frameworks (rsqrt vs 1/sqrt, sin/cos of the
# lens sample): a few ulps of coordinates up to ~13 in magnitude
ATOL = 1e-5


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_make_camera_basis(name):
    args = CAMERAS[name]
    j = jmake(*args[:5], aperture=args[5], focus_dist=args[6])
    t = tmake(*args[:5], aperture=args[5], focus_dist=args[6])
    for field in Camera._fields:
        np.testing.assert_allclose(getattr(t, field).numpy(),
                                   np.asarray(getattr(j, field)),
                                   rtol=0, atol=ATOL, err_msg=field)


@pytest.mark.parametrize("name", sorted(CAMERAS))
@pytest.mark.parametrize("sample", [0, 37])
def test_generate_rays(name, sample):
    args = CAMERAS[name]
    j = jmake(*args[:5], aperture=args[5], focus_dist=args[6])
    t = tmake(*args[:5], aperture=args[5], focus_dist=args[6])
    nx, ny = 48, 32
    pix = np.arange(nx * ny, dtype=np.uint32)
    jo, jd = j.generate_rays(jnp.asarray(pix), jnp.uint32(sample), nx, ny)
    to, td = t.generate_rays(torch.from_numpy(pix.astype(np.int64)), sample,
                             nx, ny)
    for a, b in zip((*jo, *jd), (*to, *td)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)
    norms = torch.sqrt(td.squared_length())
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-6)
