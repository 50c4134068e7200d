"""cudatracerlib_tpu_torch — the PyTorch/CUDA port of cudatracerlib_tpu.

Mirrors the JAX package's layout (``core/ scene/ ops/ models/ parallel/
utils/`` and the command-line renderer, ``python -m cudatracerlib_tpu_torch``)
file for file and function for function. Plain tensor code is PyTorch; the one
kernel on the progressive path-tracing pass, the BVH8 traversal, is CUDA C++
written for Hopper (``csrc/traversal8.cu``, built at first use). The package
imports neither JAX nor the JAX package; it runs on the CPU with the
kernel's plain PyTorch version and on a CUDA device with the kernel.
"""

__version__ = "0.1.0"
