"""RAPID-Serve on PyTorch and CUDA for NVIDIA Hopper.

A port of ``repro`` (JAX/Pallas) that imports neither JAX nor ``repro``:
every module it needs is copied here under the same name, and every
Pallas kernel on the serving path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (``kernels/build.py``).
"""
