"""PyTorch/CUDA port of the decentralized-optimization framework.

A second package beside ``distributed_optimization_tpu`` (the JAX
reference), ported slice by slice. It imports torch, numpy and scipy, and
nothing of JAX or of the JAX package. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""
