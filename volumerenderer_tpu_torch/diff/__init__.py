"""Differentiable rendering: the learnable transfer function, the O(1)-memory
reverse march and the closed-form adjoint the gradient kernels compute.

Counterpart of ``volumerenderer_tpu/diff/``."""
