"""PyTorch / CUDA port of the raytracing_cuda_tpu renderer.

A second package beside the JAX one, with the same layout (core, scene, sim,
render, utils, app). Plain tensor code is PyTorch; the two TPU kernels of
the render path (the raytracing megakernel and FXAA) are CUDA C++ kernels
under csrc/, built with nvcc at first use (see _build.py) and launched
through ctypes. Every kernel wrapper keeps a plain PyTorch version beside
it, which it runs only for tensors on the CPU.
"""
