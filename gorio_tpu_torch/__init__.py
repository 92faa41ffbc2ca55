"""PyTorch/CUDA port of `gorio_tpu` for one NVIDIA H100.

Mirrors `gorio_tpu/`'s layout module for module. Plain tensor code is
PyTorch; the two Pallas 1-NN kernels of `gorio_tpu/ops/nn_pallas.py` are
hand-written CUDA C++ under `ops/csrc/`. The package never imports JAX.
"""
