"""Hand-written CUDA kernels for the hot spots of the serving path.

Each kernel has: ``csrc/<name>.cu`` (the CUDA source), a wrapper in
``<name>.py`` (checks, launch, launch counter), a layout wrapper in
``ops.py``, and a plain PyTorch version in ``ref.py`` that the wrapper
computes for CPU tensors and that the tests hold the kernel against.
"""
