"""tpu_pathtracer_torch — the path tracer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX/Pallas package ``tpu_pathtracer``, which stays the
reference it is tested against. Module names mirror the JAX package.
This package imports ``torch`` and numpy only, never ``jax``.

Importing it builds nothing: each CUDA kernel is compiled from
``csrc/`` by :mod:`tpu_pathtracer_torch.ops._build` on its first launch.
"""

from tpu_pathtracer_torch.config import RenderConfig

__version__ = "0.1.0"

__all__ = ["RenderConfig", "__version__"]
