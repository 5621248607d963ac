"""repro_torch: the PyTorch and CUDA port of the MERINDA recovery system.

Each module answers to one module of the JAX package ``repro`` and imports
nothing of it, nor JAX. Its hand-written CUDA kernels live in
``kernels/csrc`` and are built on first use (``kernels/runtime.py``).
"""
