"""Kernels written by hand for Hopper, one per Pallas kernel of the JAX
package, each beside its plain PyTorch version:

* flash_attention — blocked online-softmax GQA attention, forward only
  (CUDA C++, ``csrc/flash_attention.cu``), on the prefill path.

``ops`` is the public entry: a CUDA tensor goes to the kernel, a CPU
tensor to the plain version. ``ref`` holds the test oracles. Nothing is
re-exported here, so ``repro_torch.kernels.flash_attention`` stays the
module, launch counter included.
"""
