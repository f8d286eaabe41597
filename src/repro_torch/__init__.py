"""EdgeServing ported to PyTorch and CUDA for NVIDIA Hopper.

Mirrors the JAX reference package ``repro`` module for module. It imports
torch and numpy, never JAX and nothing of ``repro``. Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""
