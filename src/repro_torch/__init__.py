"""PyTorch/CUDA port of the ACPD reproduction, beside the JAX package ``repro``.

The package mirrors ``repro`` module for module. Plain tensor code is
PyTorch; the worker's SDCA inner loop, the top-k message filter and the
flash-attention forward of the model stack's prefill are hand-written CUDA
kernels for Hopper (``csrc/``), built by ``nvcc`` at first use. Entry points
run on the CUDA device unless the caller passes ``device="cpu"``. Nothing
here imports JAX or ``repro``.
"""
