"""Float constants shared by the port (counterpart of
``tpu_pathtracer/ops/vec.py``). The interleaved ``[..., 3]`` helpers of
the JAX module have no caller on the port's paths: vector math is the
component-SoA :class:`~tpu_pathtracer_torch.ops.v3.V3`."""

FLT_MAX = 3.4028234663852886e38  # float32 max, exact as a Python float
