"""The port's mesh inputs against the JAX package's: the BVH builder (both
builders), ``BVH_00.04`` files across the two packages, the procedural
staircase, the texture atlas and texel fetch, OBJ loading, the staircase
camera and the all-triangles oracle. Everything here is host-side numpy
or a plain PyTorch pass, so arrays are held equal element for element
unless a test says otherwise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pathtracer import native as j_native
from tpu_pathtracer.camera import staircase_camera as j_stair_cam
from tpu_pathtracer.models import mesh as jmesh
from tpu_pathtracer.models import obj as jobj
from tpu_pathtracer.ops import bvh as jbvh
from tpu_pathtracer.ops import texture as jtex
from test_torch_render import jax_fields
from tpu_pathtracer_torch import native
from tpu_pathtracer_torch.camera import staircase_camera
from tpu_pathtracer_torch.convert import scene_from_numpy
from tpu_pathtracer_torch.models import mesh as tmesh
from tpu_pathtracer_torch.models import obj as tobj
from tpu_pathtracer_torch.models.scene import MeshData, Scene
from tpu_pathtracer_torch.ops import bvh as tbvh
from tpu_pathtracer_torch.ops import texture as ttex

_MESH_ARRAYS = ("v0", "v1", "v2", "tex_coords", "mesh_id", "bvh_min",
                "bvh_max", "bounds_min", "bounds_max")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_mesh_equal(tm: MeshData, jm):
    for k in _MESH_ARRAYS:
        a, b = _np(getattr(tm, k)), _np(getattr(jm, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert tm.first_leaf == jm.first_leaf
    assert tm.prims_per_leaf == jm.prims_per_leaf
    assert (tm.brute is None) == (jm.brute is None)
    if tm.brute is not None:
        for a, b in zip(tm.brute, jm.brute):
            assert _np(a).dtype == _np(b).dtype
            np.testing.assert_array_equal(_np(a), _np(b))


def _soup(t, seed):
    rng = np.random.RandomState(seed)
    v0 = rng.uniform(-10, 10, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    tc = rng.uniform(0, 1, (t, 6)).astype(np.float32)
    mid = rng.randint(0, 20, t).astype(np.int32)
    return v0, v1, v2, tc, mid


MESHES = {"staircase": lambda: tmesh.procedural_staircase_mesh(),
          "soup_1000": lambda: _soup(1000, seed=1),
          "soup_full_leaves": lambda: _soup(640, seed=2)}


@pytest.mark.parametrize("builder", ["median", "auto"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_build_bvh_equals_jax(name, builder):
    arrays = MESHES[name]()
    tm = tbvh.build_bvh(*arrays, prims_per_leaf=5, builder=builder)
    jm = jbvh.build_bvh(*arrays, prims_per_leaf=5, builder=builder)
    assert_mesh_equal(tm, jm)
    if builder == "auto":
        # both packages take the same builder on the same machine
        assert (native.load() is None) == (j_native._load() is None)
    if name == "soup_full_leaves":
        assert tm.brute is None  # 640 = 128 leaves x 5: no padding
    if name == "staircase":
        assert tm.num_tris == 640 and tm.brute[0].shape == (384, 3)


def test_sah_builder_order():
    if native.load() is None:
        pytest.skip("the native SAH builder does not build here (g++)")
    arrays = MESHES["soup_1000"]()
    tm = tbvh.build_bvh(*arrays, builder="sah")
    assert_mesh_equal(tm, jbvh.build_bvh(*arrays, builder="sah"))
    median = tbvh.build_bvh(*arrays, builder="median")
    assert not torch.equal(tm.v0, median.v0)  # a different order


def test_median_order_and_node_boxes_equal_jax():
    v0, v1, v2, _, _ = _soup(300, seed=3)
    cent = (v0 + v1 + v2) / 3.0
    a = tbvh._median_order(cent, 64, 5)
    np.testing.assert_array_equal(a, jbvh._median_order(cent, 64, 5))
    pad = lambda x: np.concatenate([x, np.full((20, 3), np.inf,
                                               np.float32)])
    args = (pad(v0), pad(v1), pad(v2), 64, 5)
    for x, y in zip(tbvh._node_boxes(*args), jbvh._node_boxes(*args)):
        np.testing.assert_array_equal(x, y)


def test_bvh4_meshes_raise_naming_slice_3():
    v0, v1, v2, _, _ = _soup(9000, seed=4)
    assert jbvh._bvh4_auto_eligible(9000) == tbvh._bvh4_auto_eligible(9000)
    with pytest.raises(NotImplementedError, match="slice 3"):
        tbvh.build_bvh(v0, v1, v2, builder="median")
    with pytest.raises(NotImplementedError, match="slice 3"):
        tbvh.build_bvh(v0[:50], v1[:50], v2[:50], bvh4=True)
    small = tbvh.build_bvh(v0[:50], v1[:50], v2[:50], bvh4="auto")
    assert small.bvh4 is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bvh_file_across_packages(tmp_path, writer):
    arrays = tmesh.procedural_staircase_mesh()
    path = str(tmp_path / "stairs.bvh")
    jm = jbvh.build_bvh(*arrays, builder="median")
    tm = tbvh.build_bvh(*arrays, builder="median")
    if writer == "jax":
        jbvh.save_bvh_file(path, jm)
        back = tbvh.load_bvh_file(path)
        other = jbvh.load_bvh_file(path)
    else:
        tbvh.save_bvh_file(path, tm)
        back = tbvh.load_bvh_file(path)
        other = jbvh.load_bvh_file(path)
    assert back.brute is None  # a file's mesh keeps its heap order
    assert_mesh_equal(back, other)
    np.testing.assert_array_equal(back.v0.numpy(), tm.v0.numpy())
    with open(path, "rb") as f:
        raw = f.read()
    other_path = str(tmp_path / "other.bvh")
    (jbvh.save_bvh_file if writer == "port" else tbvh.save_bvh_file)(
        other_path, jm if writer == "port" else tm)
    with open(other_path, "rb") as f:
        assert f.read() == raw  # byte for byte


def test_bvh_file_rejects_wide_mesh_ids(tmp_path):
    arrays = list(_soup(20, seed=5))
    arrays[4][3] = 300
    tm = tbvh.build_bvh(*arrays, builder="median")
    with pytest.raises(ValueError, match="uint8"):
        tbvh.save_bvh_file(str(tmp_path / "x.bvh"), tm)
    with open(tmp_path / "bad.bvh", "wb") as f:
        f.write(b"BVH_00.03\x00")
    with pytest.raises(ValueError, match="header"):
        tbvh.load_bvh_file(str(tmp_path / "bad.bvh"))


def test_staircase_scene_equals_jax():
    for a, b in zip(tmesh.procedural_staircase_mesh(sub=2),
                    jmesh.procedural_staircase_mesh(sub=2)):
        np.testing.assert_array_equal(a, b)
    ts, tc = tmesh.procedural_staircase_scene(48, 32)
    js, jc = jmesh.procedural_staircase_scene(48, 32)
    want = jax_fields(js)
    for f in dataclasses.fields(Scene):
        got, exp = getattr(ts, f.name), want[f.name]
        if f.name == "mesh":
            assert_mesh_equal(got, js.mesh)
        elif f.name == "materials":
            for k, v in exp.items():
                np.testing.assert_array_equal(getattr(got, k).numpy(), v)
        elif isinstance(exp, np.ndarray):
            np.testing.assert_array_equal(got.numpy(), exp, err_msg=f.name)
        else:
            assert got == exp, f.name
    # the converted JAX scene carries the mesh across whole
    conv = scene_from_numpy(want, "cpu")
    assert_mesh_equal(conv.mesh, js.mesh)
    assert conv.mesh.mesh_id.dtype == conv.mesh.brute[4].dtype == torch.int32
    for a, b in zip(conv.mesh.brute, ts.mesh.brute):
        assert torch.equal(a, b)


def test_staircase_camera_equals_jax():
    tc = staircase_camera(64, 48)
    jc = j_stair_cam(64, 48)
    for k in tc._fields:
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-5,
                                   rtol=1e-6)
    pix = torch.arange(64 * 48)
    o, d = tc.generate_rays(pix, 3, 64, 48)
    jo, jd = jc.generate_rays(jnp.arange(64 * 48), 3, 64, 48)
    for a, b in zip((*o, *d), (*jo, *jd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


def test_atlas_and_fetch_equal_jax():
    images = tmesh.procedural_textures()
    for a, b in zip(images, jmesh.procedural_textures()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(6)
    images = images + [rng.uniform(0, 1, (37, 21, 3)).astype(np.float32)]
    atlas, w, h = ttex.build_atlas(images)
    for a, b in zip((atlas, w, h), jtex.build_atlas(images)):
        np.testing.assert_array_equal(a, b)
    n = 4096
    tid = rng.randint(-1, len(images), n).astype(np.int32)
    tu = rng.uniform(-3, 3, n).astype(np.float32)
    tv = rng.uniform(-3, 3, n).astype(np.float32)
    tu[:8] = [0.0, 1.0, -1.0, 0.999999, -0.0, 2.5, 1e-8, -1e-8]
    got = ttex.fetch(*(torch.from_numpy(x) for x in (atlas, w, h, tid, tu,
                                                     tv)))
    exp = jtex.fetch(*(jnp.asarray(x) for x in (atlas, w, h, tid, tu, tv)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_load_texture_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(7)
    px = rng.randint(0, 256, (9, 13, 4)).astype(np.uint8)
    path = str(tmp_path / "t.png")
    Image.fromarray(px, "RGBA").save(path)
    a = ttex.load_texture(path)
    np.testing.assert_array_equal(a, jtex.load_texture(path))
    assert a.shape == (9, 13, 3) and a.dtype == np.float32


OBJ = """# a quad, a triangle with texcoords, a fan and negative indices
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
f 1 2 3 4
f 1/1 2/2 3/3
f 1//1 3//1 4//1
v 0 0 1
v 1 0 1
v 0.5 1 1.5
f -3/-3 -2/-2 -1/-1
"""


def test_load_obj_equals_jax(tmp_path):
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write(OBJ)
    got = tobj.load_obj(path)
    for a, b in zip(got, jobj.load_obj(path)):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (5, 3)
    ts, tc = tobj.load_obj_scene(path, 32, 24, prims_per_leaf=4)
    js, jc = jobj.load_obj_scene(path, 32, 24, prims_per_leaf=4)
    assert_mesh_equal(ts.mesh, js.mesh)
    for k in ("light_center", "light_radius", "light_color"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-6)
    for k in tc._fields:
        np.testing.assert_allclose(getattr(tc, k).numpy(),
                                   np.asarray(getattr(jc, k)), atol=1e-5)


@pytest.mark.parametrize("t_max", ["flt_max", "per_ray"])
def test_brute_force_equals_jax(t_max):
    """The oracle on the staircase's padded heap arrays (sentinels
    included) from inside the room. idx exact; t, u, v to XLA's CPU FMA
    contraction: 1e-5 relative on t, 1e-5 absolute on u and v."""
    tm, _ = tmesh.procedural_staircase_scene(8, 8)
    jm = jmesh.procedural_staircase_scene(8, 8)[0].mesh
    rng = np.random.RandomState(8)
    n = 600
    o = (rng.uniform(-1, 1, (n, 3)) * [300, 200, 300] + [0, 250, 100]
         ).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = (np.float32(3.4028235e38) if t_max == "flt_max"
            else rng.uniform(-1, 400, n).astype(np.float32))
    got = tbvh.brute_force(tm.mesh, torch.from_numpy(o),
                           torch.from_numpy(d), 0.01,
                           torch.as_tensor(tmax))
    exp = jbvh.brute_force(jm, jnp.asarray(o), jnp.asarray(d), 0.01,
                           jnp.asarray(tmax))
    idx = got.tri_id.numpy()
    np.testing.assert_array_equal(idx, np.asarray(exp.tri_id))
    hit = idx >= 0
    assert hit.sum() > n // 10
    np.testing.assert_allclose(got.t.numpy(), np.asarray(exp.t), rtol=1e-5)
    for a, b in ((got.u, exp.u), (got.v, exp.v)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   atol=1e-5)
    assert not np.isin(idx[hit], np.flatnonzero(
        ~np.isfinite(tm.mesh.v0.numpy()).all(1))).any()
