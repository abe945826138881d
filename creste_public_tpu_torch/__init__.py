"""PyTorch/CUDA port of creste_public_tpu for NVIDIA Hopper (H100).

The JAX package ``creste_public_tpu`` is the reference; this package imports
neither JAX nor anything of it. Public functions keep the JAX layout at the
boundary (NHWC in, NHWC out); modules run NCHW inside and make their input
NCHW-contiguous where they take an NHWC map (cuDNN's f32 kernels for
channels_last tensors are several times slower on an H100). The deployment entry
point is ``runtime.export.build_inference_fn``.
"""
