"""PyTorch/CUDA port of hiast_tpu for NVIDIA Hopper (H100).

The JAX package ``hiast_tpu`` is the reference; this package imports none of
it.  Modules keep the reference's layout and names so each counterpart is
found at the same path.  Ported so far: IAS pseudo-label generation on
DeepLab-v2/ResNet-101 (``python -m hiast_tpu_torch.cli.generate_pseudo_labels``)
with its two selection kernels in CUDA (``ops/cuda/select_kernel.py``).
"""
