"""Hand-written Hopper kernels (↔ deeplearning4j_tpu.kernels, the Pallas ones).

Each kernel module holds the kernel's wrapper, its plain PyTorch version
and a dispatching entry point (``_dispatch.use_kernel``): a CUDA tensor
launches the kernel, a CPU tensor runs the plain version. CUDA sources live
in ``csrc/`` and are built at first use by ``_build``.
"""
