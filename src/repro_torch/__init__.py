"""repro_torch — the Flora live-market selection path on PyTorch and CUDA.

The package mirrors the module layout of the JAX reference package
``repro`` so that each module's counterpart is easy to find, and keeps its
own copies of what it needs: it imports ``torch``, ``numpy`` and the
standard library, never ``jax`` and nothing of ``repro``.

The fleet tick of the ``torch_fused`` backend runs through hand-written
CUDA kernels (:mod:`repro_torch.kernels.rank_delta`, sources in
``csrc/``), built with ``nvcc`` on first use.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU, where the
kernels' plain PyTorch versions run instead.
"""
