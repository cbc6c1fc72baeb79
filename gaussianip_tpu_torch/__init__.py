"""PyTorch / CUDA port of gaussianip_tpu for NVIDIA Hopper (H100).

Module paths mirror the JAX package (``gaussianip_tpu/render/preprocess.py``
-> ``gaussianip_tpu_torch/render/preprocess.py``); the one rename is
``human/smplx_jax.py`` -> ``human/smplx.py``, and the Pallas compositor
``render/composite_pallas.py`` becomes ``render/composite_cuda.py`` with its
kernels in ``csrc/composite.cu``.

The package imports torch and numpy only. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
