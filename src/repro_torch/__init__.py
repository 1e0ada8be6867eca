"""repro_torch: the PyTorch/CUDA port of the LIME reproduction.

A second package beside the JAX reference (``repro``), with the same
module names so each counterpart is easy to find. It imports ``torch``,
never ``jax`` and nothing of ``repro``; what it needs of the JAX
package's framework-free modules it keeps as its own copy.

Entry points run on the card (``cuda``) unless the caller passes
``device="cpu"``; without a card and without that request they raise.
The attention kernels are hand-written CUDA C++ for Hopper
(``csrc/``), built at first use; on CPU tensors their wrappers take the
plain PyTorch versions that sit beside them.
"""
