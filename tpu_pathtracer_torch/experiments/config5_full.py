"""BASELINE config 5 on the card: the procedural staircase at 3840x2160,
1000 spp, depth 64, in checkpointed sample batches (``CKPT_00.02``) —
the port's counterpart of ``experiments/config5_full.py``.

    python -m tpu_pathtracer_torch.experiments.config5_full [ns] [batch] [ckpt_path]

``ns`` (default 1000) samples in batches of ``batch`` (default 16), each
batch checkpointed to ``ckpt_path``; kill it at any point and rerunning
with the same path resumes bit-exactly (counter RNG). Without
``ckpt_path`` the checkpoint and the PNG go into a new temporary
directory; with it, the PNG is written beside the checkpoint
(``config5_4k.png``). Needs a CUDA device; prints the card's
``nvidia-smi`` name and power limit first.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

from tpu_pathtracer_torch.experiments.common import card


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    dev = card("config5_full")
    ns = int(argv[0]) if len(argv) > 0 else 1000
    batch = int(argv[1]) if len(argv) > 1 else 16
    path = (argv[2] if len(argv) > 2 else
            os.path.join(tempfile.mkdtemp(prefix="config5_"),
                         "config5.ckpt"))

    from tpu_pathtracer_torch.config import RenderConfig
    from tpu_pathtracer_torch.models.mesh import procedural_staircase_scene
    from tpu_pathtracer_torch.utils.checkpoint import render_with_checkpoints
    from tpu_pathtracer_torch.utils.image import write_png

    cfg = RenderConfig(nx=3840, ny=2160, ns=ns, max_depth=64)
    scene, cam = procedural_staircase_scene(cfg.nx, cfg.ny, device=dev)

    t0 = time.perf_counter()
    last = [t0]

    def progress(done, total):
        now = time.perf_counter()
        print(f"  {done:5d}/{total} spp  (+{now - last[0]:6.1f} s, "
              f"total {now - t0:7.1f} s)", flush=True)
        last[0] = now

    img = render_with_checkpoints(scene, cam, cfg, path, batch=batch,
                                  progress=progress)
    el = time.perf_counter() - t0
    print(f"config5 staircase 3840x2160@{ns}spp: {el:.1f} s "
          f"({el / ns * 1e3:.0f} ms/spp) mean={img.mean():.5f}")
    png = os.path.join(os.path.dirname(os.path.abspath(path)),
                       "config5_4k.png")
    write_png(png, img)
    print(f"wrote {png} (checkpoint {path})")


if __name__ == "__main__":
    main()
