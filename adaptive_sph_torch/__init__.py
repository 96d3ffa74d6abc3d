"""PyTorch + CUDA port of the adaptive SPH simulator (see README.md, "PyTorch port").

The JAX package `adaptive_sph_tpu` is the reference; this package never imports it
or jax. Entry point: `adaptive_sph_torch.runner.create_simulation`.
"""
