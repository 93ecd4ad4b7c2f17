"""Hand-written Hopper kernels (csrc/*.cu), each beside its plain version.

A wrapper takes the plain PyTorch version only for tensors on the CPU; for
a CUDA tensor it launches its kernel or raises.  `build.KERNELS` holds each
kernel's launch count."""
