"""PyTorch/CUDA port of flashattn_tpu for NVIDIA Hopper.

The serving path (prefill through the flash forward, decode through the
flash-decode kernel, the continuous-batching server) runs on hand-written
CUDA kernels under ``csrc/``; plain tensor code is PyTorch. The JAX package
``flashattn_tpu`` stays the reference that every module is tested against.
"""
