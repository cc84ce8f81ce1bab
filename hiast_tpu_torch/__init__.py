"""PyTorch/CUDA port of hiast_tpu for NVIDIA Hopper (H100).

The JAX package ``hiast_tpu`` is the reference; this package imports none of
it.  Modules keep the reference's layout and names so each counterpart is
found at the same path.  Ported so far: the HIAST round driver
(``python -m hiast_tpu_torch.cli.run_rounds``) over pseudo-label generation
(IAS, CT, NT, CBST, multi-scale/flip; ``cli.generate_pseudo_labels``),
self-training and HIAST consistency training (``cli.train``) and
validation (``cli.validate``), on DeepLab-v2/ResNet-101 and SegFormer
(MiT-B0..B5), with the two selection kernels (``ops/cuda/select_kernel.py``)
and the SRA attention forward and backward (``ops/cuda/attention.py``) in
CUDA; configs in ``configs/``, read by ``config/yaml_subset.py``.
"""
