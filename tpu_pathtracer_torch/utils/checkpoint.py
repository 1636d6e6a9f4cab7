"""Accumulation-buffer checkpoint / resume (counterpart of
``tpu_pathtracer/utils/checkpoint.py``).

A checkpoint is the linear radiance *sum* buffer plus the number of
samples completed: because the RNG is counter-based, resuming at sample k
traces exactly the samples a straight run would have traced (BASELINE
config 5: 4K at 1000 spp in checkpointed batches).

Format: ``CKPT_00.02`` header, nx, ny, samples_done, scene/config
fingerprint (uint64), float32 sum buffer — byte for byte the JAX
package's, so a file written by one package is resumed by the other.
``CKPT_00.01`` (no fingerprint) is still readable.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Callable, Optional

import numpy as np
import torch

CKPT_HEADER = b"CKPT_00.02"
_CKPT_HEADER_V1 = b"CKPT_00.01"


def _leaves(obj):
    """The scene's arrays in the order ``jax.tree.leaves`` walks the JAX
    package's scene: dataclass data fields in declaration order (into
    ``Materials`` and ``MeshData``), tuple items in order, ``None`` and the
    static fields (plain Python scalars: ``use_nee``, ``sky_mode``,
    ``first_leaf``, ``prims_per_leaf``) dropped. A mesh's BVH4 tables are
    skipped: see :func:`scene_fingerprint`."""
    if isinstance(obj, torch.Tensor):
        yield obj.detach().cpu().numpy()
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.name != "bvh4":
                yield from _leaves(getattr(obj, f.name))
    elif isinstance(obj, tuple):
        for item in obj:
            yield from _leaves(item)


def scene_fingerprint(scene, config) -> int:
    """Cheap stable digest of the scene + the config fields that change
    radiance, so a checkpoint written for one render can't silently seed a
    different one.

    The CRC runs over each array's bytes, then its NumPy dtype name, then
    the same config key as the JAX package's. The port's scene holds the
    JAX dtypes (float32, int32), so for a scene without BVH4 tables (the
    sphere scenes, the staircase toy) the digest equals the JAX package's
    ``scene_fingerprint`` of the same scene. A mesh's BVH4 tables are left
    out: they are built from the heap mesh, which the digest covers, and
    the JAX package's carry TPU DMA ``blocks`` the port does not build, so
    a scene with BVH4 tables (staircase-hires, the packet-path zoo) has a
    different digest in each package.
    """
    crc = 0
    for a in _leaves(scene):
        crc = zlib.crc32(a.tobytes(), crc)
        crc = zlib.crc32(str(a.dtype).encode(), crc)
    key = (config.nx, config.ny, config.max_depth, config.epsilon,
           config.russian_roulette, config.rr_start_bounce, config.shadow,
           config.textures)
    return zlib.crc32(repr(key).encode(), crc) & 0xFFFFFFFF


def save_checkpoint(path: str, sum_buffer: np.ndarray, samples_done: int,
                    fingerprint: int = 0) -> None:
    ny, nx, _ = sum_buffer.shape
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(CKPT_HEADER)
        f.write(struct.pack("<iiiQ", nx, ny, samples_done, fingerprint))
        f.write(np.ascontiguousarray(sum_buffer, np.float32).tobytes())
    os.replace(tmp, path)  # atomic: a torn write never corrupts the ckpt


def load_checkpoint(path: str):
    """Returns (sum_buffer [ny,nx,3], samples_done, fingerprint) or None
    if absent. V1 checkpoints load with fingerprint None (unchecked)."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        header = f.read(len(CKPT_HEADER))
        if header == CKPT_HEADER:
            nx, ny, done, fp = struct.unpack("<iiiQ", f.read(20))
        elif header == _CKPT_HEADER_V1:
            nx, ny, done = struct.unpack("<iii", f.read(12))
            fp = None
        else:
            raise ValueError(f"invalid checkpoint header {header!r}")
        data = np.frombuffer(f.read(nx * ny * 12), np.float32)
    return data.reshape(ny, nx, 3).copy(), done, fp


def render_with_checkpoints(scene, camera, config, path: str,
                            batch: int = 16,
                            progress: Optional[Callable[[int, int], None]] = None,
                            devices=None) -> np.ndarray:
    """Progressive render: trace ``batch`` samples at a time, checkpoint
    after each batch, resume automatically if ``path`` exists. Returns the
    final mean-radiance image [ny, nx, 3].

    A batch is the regeneration engine's radiance sum over sample indices
    [done, done+batch), traced exactly as a straight run would trace them
    (``engine.regen.render_sample_range``). With ``devices`` a batch is
    split into pixel stripes over that device list
    (``parallel.tiles.render_image_tiled_regen``); radiance is the same
    either way because the counter RNG is keyed by global pixel id. The
    sum buffer is float32 NumPy on the host, as in the JAX package: one
    device-to-host copy a batch (a stripe with ``devices``).
    """
    from tpu_pathtracer_torch.engine.regen import render_sample_range

    fp = scene_fingerprint(scene, config)
    state = load_checkpoint(path)
    if state is None:
        acc = np.zeros((config.ny, config.nx, 3), np.float32)
        done = 0
    else:
        acc, done, ckpt_fp = state
        if acc.shape != (config.ny, config.nx, 3):
            raise ValueError("checkpoint resolution mismatch")
        if done > config.ns:
            raise ValueError(
                f"checkpoint has {done} samples done > config.ns={config.ns};"
                " refusing to produce a mean over the wrong sample count")
        if ckpt_fp is not None and ckpt_fp != fp:
            raise ValueError(
                "checkpoint scene/config fingerprint mismatch: the file was"
                " written for a different render")

    while done < config.ns:
        take = min(batch, config.ns - done)
        if devices is not None:
            from tpu_pathtracer_torch.parallel.tiles import \
                render_image_tiled_regen
            part = render_image_tiled_regen(scene, camera, config,
                                            devices=devices, ns=take,
                                            s0=done, normalize=False)
        else:
            part = render_sample_range(scene, camera, config, done, take)
        acc = acc + part  # part is a SUM over `take` samples
        done += take
        save_checkpoint(path, acc, done, fp)
        if progress is not None:
            progress(done, config.ns)

    return acc / config.ns
