"""tf_operator_tpu_torch — the PyTorch/CUDA port of tf_operator_tpu's data plane.

A package of its own beside the JAX package, with the same sub-package
names so each module's counterpart is easy to find. It imports torch and
never jax, flax, optax or anything of tf_operator_tpu. Entry points run on
CUDA unless the caller asks for the CPU; the attention kernels are
hand-written for Hopper (csrc/), with plain PyTorch versions beside them
that run on CPU tensors.
"""
