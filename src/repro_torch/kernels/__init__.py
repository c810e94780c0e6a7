"""Kernels written by hand for Hopper, one per Pallas kernel of the JAX
package, each beside its plain PyTorch version:

* flash_attention — blocked online-softmax GQA attention (CUDA C++,
  ``csrc/flash_attention.cu``): the forward on the attention prefill path,
  and a forward and backward on the attention training path;
* ssd_scan — the Mamba-2 SSD chunked scan, forward only (CUDA C++,
  ``csrc/ssd_scan.cu``), on the Mamba prefill path.

In bf16 the kernels compute on the tensor cores through the inline-PTX
helpers of ``csrc/tc_bf16.cuh``; in fp32 the forwards are scalar kernels.

``ops`` is the public entry: a CUDA tensor goes to the kernel, a CPU
tensor to the plain version. ``ref`` holds the test oracles. Nothing is
re-exported here, so ``repro_torch.kernels.flash_attention`` and
``repro_torch.kernels.ssd_scan`` stay the modules, launch counters
included.
"""
