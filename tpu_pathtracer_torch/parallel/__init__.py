"""Image tiles over several devices (counterpart of
``tpu_pathtracer/parallel``)."""
