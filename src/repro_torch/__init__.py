"""PyTorch/CUDA port of the QuanTA reproduction, held against the JAX
package ``repro`` module by module.

The layout mirrors ``repro``: ``core`` (factorize, adapters, quanta,
peft), ``kernels`` (hand-written Hopper kernels beside their plain
PyTorch versions), ``models`` (dense transformer), ``configs``, ``serve``
(dense-cache serving engine) and ``interop`` (the JAX package's arrays,
as numpy, into the port's tensors).  Entry points run on the card unless
the caller passes ``device="cpu"``.  Nothing here imports ``jax`` or
``repro``.
"""
