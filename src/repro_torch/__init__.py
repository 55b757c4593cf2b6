"""PyTorch/CUDA port of the CodedPrivateML system (the JAX package ``repro``
is its reference).

Same module layout as ``repro``: ``repro_torch.core.field`` mirrors
``repro.core.field`` and so on.  Field elements are int32 tensors in [0, p)
at every public boundary; products are formed in int64 inside functions.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``repro_torch.device.resolve``).  On a CUDA tensor every field matmul and
worker step launches a hand-written Hopper kernel (``kernels/csrc``); on a
CPU tensor the kernels' plain PyTorch versions run instead.

This package imports torch and never jax, and nothing of ``repro``.
"""
