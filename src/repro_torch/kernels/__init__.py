"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (sources in ``repro_torch/csrc``, built lazily by ``_build``)."""
