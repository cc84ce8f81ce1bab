"""Weights into the port: JAX variable trees and reference ``.pth`` files.

The port's modules keep the torch reference parameter names, so a port
``state_dict`` IS the reference ``.pth`` layout.  This module carries
weights across:

- ``flax_to_port_state_dict``: the JAX package's ``{'params',
  'batch_stats'}`` tree (numpy leaves) -> a state_dict the port's
  ``DeepLabV2`` loads with ``strict=True``.  Key mapping (flax -> torch):

      params/backbone/layer3_5/conv2/kernel -> backbone.layer3.5.conv2.weight
      params/backbone/bn1/scale|bias        -> backbone.bn1.weight|bias
      batch_stats/backbone/bn1/mean|var     -> backbone.bn1.running_mean|var
      .../downsample_conv|downsample_bn     -> .../downsample.0|downsample.1
      aspp/conv2d_list_I                    -> aspp.conv2d_list.I
      representation                        -> representation.0

  Conv kernels transpose HWIO -> OIHW.  BatchNorm's ``num_batches_tracked``
  (a torch-only counter) is set to 0.
- ``reference_to_port_state_dict``: a reference ``.pth`` state_dict -> port
  keys: strips the ``module.`` (DDP) and ``seg_model.`` (segmentor) prefixes,
  and maps a bare torchvision ResNet (``conv1.*``, ``layer1.*``, ``fc.*``)
  into ``backbone.`` with the ImageNet classifier dropped (reference:
  code/sseg/models/modules/resnet.py:193-214).
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _torch_module_name(flax_path: tuple[str, ...]) -> str:
    name = ".".join(flax_path)
    name = re.sub(r"layer(\d+)_(\d+)", r"layer\1.\2", name)
    name = name.replace("downsample_conv", "downsample.0")
    name = name.replace("downsample_bn", "downsample.1")
    name = re.sub(r"conv2d_list_(\d+)", r"conv2d_list.\1", name)
    if name.endswith("representation"):
        name += ".0"
    return name


_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def flax_to_port_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` (numpy-convertible leaves) -> port state_dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
                continue
            arr = np.asarray(value, dtype=np.float32)
            mod = _torch_module_name(prefix)
            if key == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
                out[f"{mod}.weight"] = torch.from_numpy(np.ascontiguousarray(arr))
            elif key in _LEAF:
                out[f"{mod}.{_LEAF[key]}"] = torch.from_numpy(np.array(arr))
            else:
                raise KeyError(f"unhandled flax leaf {key!r} at {mod}")

    walk(variables.get("params", {}), ())
    walk(variables.get("batch_stats", {}), ())
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def is_torchvision_resnet_layout(keys) -> bool:
    """True for a bare torchvision ResNet state_dict (no HIAST namespaces)."""
    bare = {k.split("module.", 1)[-1] for k in keys}
    if not any(k.startswith("conv1.") for k in bare):
        return False
    return not any(
        k.startswith(("backbone.", "seg_model.", "aspp.", "representation.", "D."))
        for k in bare
    )


def reference_to_port_state_dict(state_dict: Mapping) -> dict:
    """Reference / torchvision ``.pth`` keys -> the port's DeepLabV2 keys."""
    torchvision = is_torchvision_resnet_layout(state_dict.keys())
    out = {}
    for key, value in state_dict.items():
        key = key.split("module.", 1)[-1]
        if key.startswith("seg_model."):
            key = key[len("seg_model."):]
        if torchvision:
            if key.startswith("fc."):
                continue
            key = f"backbone.{key}"
        out[key] = value
    return out
