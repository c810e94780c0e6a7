"""PyTorch port of the `repro` compute stack, for NVIDIA Hopper GPUs.

The module tree mirrors the JAX package's (``configs``, ``models``,
``kernels``, ``serve``, ``launch``) so each module's counterpart is found
by name. The port imports ``torch`` and never ``jax`` or ``repro``; the
JAX package is the reference its tests compare against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
