"""Image tiles over a list of devices (counterpart of
``tpu_pathtracer/parallel/tiles.py``).

The flat pixel range is cut into one contiguous stripe a device. Every
lane's counter-based RNG stream is keyed by its *global* pixel id, so a
tiled render traces the same paths as a single-device one; the bounce
loop needs no communication, and the only traffic is one device-to-host
copy a stripe (and the stripes' ``Stats``, summed on the host).

The stripes run one after another from the host: each stripe's regen
loop syncs once an iteration (``engine/regen.py``'s ``done.all()``), so
two cards would not overlap without a host thread per device (ROADMAP
B-20). A device may be listed more than once, which is how one card (or
the CPU) renders several stripes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpu_pathtracer_torch.camera import Camera
from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.engine.render import auto_chunk, sample_sum
from tpu_pathtracer_torch.engine.wavefront import Stats
from tpu_pathtracer_torch.models.scene import Scene, map_tensors


def tile_devices(devices: Optional[Sequence] = None,
                 camera: Optional[Camera] = None) -> list:
    """The devices to tile over, as ``torch.device``s: ``devices`` if
    given (repeats allowed); else ``[camera.device]`` when the camera is
    not on a CUDA device; else every CUDA device."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
    elif camera is not None and camera.device.type != "cuda":
        out = [camera.device]
    else:
        out = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    if not out:
        raise RuntimeError("no device to tile over: no CUDA device, and "
                           "neither devices= nor a camera off the card")
    return out


def _stripes(scene: Scene, camera: Camera, config: RenderConfig, devices):
    """(stripe length, [(offset, scene, camera)] a stripe): the scene and
    camera moved to each device once."""
    devs = tile_devices(devices, camera)
    per_dev = -(-config.num_pixels // len(devs))
    moved = {}
    out = []
    for k, dev in enumerate(devs):
        if dev not in moved:
            moved[dev] = map_tensors((scene, camera),
                                     lambda t, d=dev: t.to(d))
        out.append((k * per_dev, *moved[dev]))
    return per_dev, out


def render_image_tiled_regen(scene: Scene, camera: Camera,
                             config: RenderConfig,
                             devices: Optional[Sequence] = None,
                             ns: Optional[int] = None, s0: int = 0,
                             normalize: bool = True) -> np.ndarray:
    """Tiled render through the regeneration engine: each device owns a
    contiguous stripe of ``ceil(n / d)`` pixels and runs its own regen
    loop to completion. Per-path radiance is bit-identical to the
    single-device regen render. Returns [ny, nx, 3] float32.

    ``ns``/``s0``/``normalize=False`` give the tiled sample-range
    primitive of checkpointed renders (BASELINE config 5): sums over
    disjoint sample ranges partition exactly.
    """
    from tpu_pathtracer_torch.engine.regen import render_regen

    per_dev, stripes = _stripes(scene, camera, config, devices)
    cfg = config.replace(stats=False)
    ns = config.ns if ns is None else ns
    parts = [render_regen(sc, cam, cfg, ns=ns, pixel_offset=off,
                          num_pixels=per_dev, s0=s0,
                          normalize=normalize).cpu().numpy()
             for off, sc, cam in stripes]
    # the last stripe may run past the frame: its tail lanes render pixel
    # ids beyond n and are dropped here
    n = config.num_pixels
    return np.concatenate(parts)[:n].reshape(config.ny, config.nx, 3)


def render_image_tiled(scene: Scene, camera: Camera, config: RenderConfig,
                       devices: Optional[Sequence] = None,
                       report_stats: bool = False):
    """Tiled render through the plain engine, bit-identical to
    :func:`~tpu_pathtracer_torch.engine.render.render_image` because RNG
    streams are keyed by global pixel id. With ``report_stats=True``
    returns (image, Stats of ints summed over the stripes).

    Samples are traced in batches of ``config.samples_per_batch`` (0 =
    all at once); a stripe's lanes in chunks of ``auto_chunk(config)``.
    """
    per_dev, stripes = _stripes(scene, camera, config, devices)
    n = config.num_pixels
    chunk = min(auto_chunk(config), per_dev)
    batch = config.samples_per_batch or config.ns
    fb = np.zeros((len(stripes) * per_dev, 3), np.float32)
    stats_total = Stats.zeros("cpu")
    for off, sc, cam in stripes:
        for start in range(off, off + per_dev, chunk):
            stop = min(start + chunk, off + per_dev)
            raw = torch.arange(start, stop, device=cam.device)
            ids = raw.clamp(max=n - 1)  # tail padding
            valid = raw < n             # pads excluded from Stats
            done = 0
            while done < config.ns:
                take = min(batch, config.ns - done)
                acc, stats = sample_sum(sc, cam, config, ids, take, done,
                                        valid=valid)
                # the mean over `take`, re-weighted into the running mean
                out = (acc / float(take)).cpu().numpy() * (take / config.ns)
                fb[start:stop] = out if done == 0 else fb[start:stop] + out
                stats_total = stats_total.add(
                    Stats(*(s.cpu() for s in stats)))
                done += take
    img = fb[:n].reshape(config.ny, config.nx, 3)
    if report_stats:
        return img, stats_total.to_ints()
    return img
