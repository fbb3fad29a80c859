"""PyTorch + CUDA port of the SQLcached device-resident cache daemon.

``repro`` (JAX) is the reference; this package mirrors its layout and
module names. It imports ``torch`` and nothing of ``jax`` or ``repro``.
Entry points run on the CUDA card unless the caller asks for the CPU
(``SQLCached(device="cpu")``); kernels live in ``csrc/`` and are built on
first use (``kernels/_build.py``).
"""
