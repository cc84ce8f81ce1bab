"""PyTorch/CUDA port of hiast_tpu for NVIDIA Hopper (H100).

The JAX package ``hiast_tpu`` is the reference; this package imports none of
it.  Modules keep the reference's layout and names so each counterpart is
found at the same path.  Ported so far: IAS pseudo-label generation
(``python -m hiast_tpu_torch.cli.generate_pseudo_labels``) and standalone
validation (``python -m hiast_tpu_torch.cli.validate``) on DeepLab-v2/
ResNet-101 and SegFormer (MiT-B0..B5), with the two selection kernels
(``ops/cuda/select_kernel.py``) and the SRA attention forward
(``ops/cuda/attention.py``) in CUDA.
"""
