"""PyTorch / CUDA port of gaussianip_tpu for NVIDIA Hopper (H100).

Module paths mirror the JAX package (``gaussianip_tpu/render/preprocess.py``
-> ``gaussianip_tpu_torch/render/preprocess.py``); the one rename is
``human/smplx_jax.py`` -> ``human/smplx.py``, and the Pallas compositor
``render/composite_pallas.py`` becomes ``render/composite_cuda.py`` with its
kernels in ``csrc/composite.cu``.

The package imports torch and numpy only. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``. The command line is
``python -m gaussianip_tpu_torch.launch`` (``launch.py``).

Component registry: config type names (``configs/exp.yaml``) map to the
port's classes and factories through ``register`` / ``find``; importing
``gaussianip_tpu_torch.components`` registers them. Importing this package
imports neither torch nor any kernel.
"""

import logging as _logging

__version__ = "0.1.0"

__modules__ = {}


def register(name):
    """Class decorator: register a component under a config-visible name."""

    def decorator(cls):
        if name in __modules__ and __modules__[name] is not cls:
            raise ValueError(f"component '{name}' already registered")
        __modules__[name] = cls
        return cls

    return decorator


def find(name):
    if name not in __modules__:
        raise KeyError(
            f"component '{name}' not registered; known: {sorted(__modules__)}"
        )
    return __modules__[name]


logger = _logging.getLogger("gaussianip_tpu_torch")
if not logger.handlers:
    _h = _logging.StreamHandler()
    _h.setFormatter(_logging.Formatter("[%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(_logging.INFO)


def info(msg, *args):
    logger.info(msg, *args)


def warn(msg, *args):
    logger.warning(msg, *args)


def debug(msg, *args):
    logger.debug(msg, *args)


def set_precision_policy() -> dict:
    """The port's float32 policy: TF32 off for matmuls and for cuDNN's
    convolutions, so float32 layers (stage 3's LPIPS) compute in full
    float32 as on the CPU. bf16 layers are unaffected. Returns the policy
    as the run manifest records it."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32}
