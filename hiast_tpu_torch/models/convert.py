"""Weights into the port: JAX variable trees and reference ``.pth`` files.

The port's modules keep the torch reference parameter names, so a port
``state_dict`` IS the reference ``.pth`` layout.  This module carries
weights across:

- ``flax_to_port_state_dict``: the JAX package's ``{'params',
  'batch_stats'}`` tree (numpy leaves) -> a state_dict the port's
  ``DeepLabV2`` or ``DeepLabV3Plus`` loads with ``strict=True``.  Key
  mapping (flax -> torch; the v3+ head's flax names, ``aspp/branch0/conv``,
  ``low_proj/bn``, ``classifier``, carry over as they are):

      params/backbone/layer3_5/conv2/kernel -> backbone.layer3.5.conv2.weight
      params/backbone/bn1/scale|bias        -> backbone.bn1.weight|bias
      batch_stats/backbone/bn1/mean|var     -> backbone.bn1.running_mean|var
      .../downsample_conv|downsample_bn     -> .../downsample.0|downsample.1
      aspp/conv2d_list_I                    -> aspp.conv2d_list.I
      representation                        -> representation.0

  Conv kernels transpose HWIO -> OIHW.  BatchNorm's ``num_batches_tracked``
  (a torch-only counter) is set to 0.  The SegFormer tree maps onto the
  mmseg names the port's ``SegFormer`` keeps (the inverse of
  ``hiast_tpu/models/convert_segformer.py:mit_state_dict_to_flax``):

      backbone/block3_17/...                -> backbone.block3.17....
      attn/k + attn/v                       -> attn.kv (concatenated, k first)
      attn/sr_norm                          -> attn.norm
      ffn/fc1|fc2|dwconv                    -> mlp.fc1|fc2|dwconv.dwconv
      decode_head/linear_c1                 -> decode_head.linear_c1.proj
      decode_head/fuse|fuse_bn              -> decode_head.linear_fuse.conv|bn
      decode_head/classifier                -> decode_head.linear_pred

  The depthwise kernel [k,k,1,C] becomes [C,1,k,k] and the fuse kernel
  [1,1,in,out] [out,in,1,1] by the same HWIO -> OIHW transpose.
- ``flax_to_discriminator_state_dict``: the JAX ``FCDiscriminator``'s
  ``{'params': {conv1..conv4, classifier}}`` -> the port's
  ``FCDiscriminator`` state_dict (HWIO -> OIHW, the same names).
- ``hf_to_port_state_dict``: a HuggingFace ``transformers`` Segformer
  state_dict (``segformer.encoder.*``) -> the port's mmseg names, with the
  separate key/value projections fused into ``attn.kv``.
- ``reference_to_port_state_dict``: a reference ``.pth`` state_dict -> port
  keys: strips the ``module.`` (DDP) and ``seg_model.`` (segmentor) prefixes,
  and maps a bare torchvision ResNet (``conv1.*``, ``layer1.*``, ``fc.*``)
  into ``backbone.`` with the ImageNet classifier dropped (reference:
  code/sseg/models/modules/resnet.py:193-214).
- ``port_state_dict``: any of these ``.pth`` contents, or a train state of
  the port, -> the port's keys (what ``load_weights`` and
  ``cli/convert_checkpoint.py`` read).
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
    # SegFormer
    name = re.sub(r"block(\d)_(\d+)", r"block\1.\2", name)
    name = re.sub(r"\.attn\.sr_norm$", ".attn.norm", name)
    name = re.sub(r"\.ffn\.(fc1|fc2)$", r".mlp.\1", name)
    name = re.sub(r"\.ffn\.dwconv$", ".mlp.dwconv.dwconv", name)
    name = re.sub(r"^decode_head\.(linear_c\d)$", r"decode_head.\1.proj", name)
    name = re.sub(r"^decode_head\.fuse_bn$", "decode_head.linear_fuse.bn", name)
    name = re.sub(r"^decode_head\.fuse$", "decode_head.linear_fuse.conv", name)
    name = re.sub(r"^decode_head\.classifier$", "decode_head.linear_pred", name)
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
    # SegFormer's separate k and v projections -> the fused kv Linear
    for key in [k for k in out if re.search(r"\.attn\.k\.(weight|bias)$", k)]:
        v_key = key.replace(".attn.k.", ".attn.v.")
        out[key.replace(".attn.k.", ".attn.kv.")] = torch.cat([out.pop(key), out.pop(v_key)], 0)
    return out


_DISCRIMINATOR_LAYERS = ("conv1", "conv2", "conv3", "conv4", "classifier")


def flax_to_discriminator_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``FCDiscriminator`` variables -> the port's ``FCDiscriminator``
    state_dict; raises on any other layer name."""
    out = flax_to_port_state_dict({"params": variables["params"]})
    want = {f"{layer}.{leaf}" for layer in _DISCRIMINATOR_LAYERS for leaf in ("weight", "bias")}
    if set(out) != want:
        raise KeyError(f"not FCDiscriminator variables: {sorted(set(out) ^ want)}")
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


_HF_BLOCK_RENAMES = {
    "layer_norm_1": "norm1",
    "layer_norm_2": "norm2",
    "attention.self.query": "attn.q",
    "attention.self.sr": "attn.sr",
    "attention.self.layer_norm": "attn.norm",
    "attention.output.dense": "attn.proj",
    "mlp.dense1": "mlp.fc1",
    "mlp.dense2": "mlp.fc2",
    "mlp.dwconv.dwconv": "mlp.dwconv.dwconv",
}


def is_hf_segformer_layout(keys) -> bool:
    return any(k.split("module.", 1)[-1].startswith("segformer.") for k in keys)


def hf_to_port_state_dict(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """HuggingFace Segformer keys -> the port's (mmseg) SegFormer keys.

    The port's copy of the renames in
    ``hiast_tpu/models/convert_segformer.py:hf_segformer_state_dict_to_flax``:
    stage indices shift from 0 to 1, ``key`` and ``value`` are concatenated
    (key first) into ``attn.kv``, and the head's ``linear_fuse``,
    ``batch_norm`` and ``classifier`` become ``linear_fuse.conv``,
    ``linear_fuse.bn`` and ``linear_pred``.  Tensors keep their layout: HF
    and mmseg store the same torch shapes."""
    out: dict[str, torch.Tensor] = {}
    kv_halves: dict = {}
    for key, value in state_dict.items():
        k = key.split("module.", 1)[-1]
        value = torch.as_tensor(value)
        if k.endswith("num_batches_tracked"):
            continue
        m = re.match(r"segformer\.encoder\.patch_embeddings\.(\d+)\.(proj|layer_norm)\.(weight|bias)$", k)
        if m:
            i, sub, leaf = m.groups()
            out[f"backbone.patch_embed{int(i) + 1}.{'proj' if sub == 'proj' else 'norm'}.{leaf}"] = value
            continue
        m = re.match(r"segformer\.encoder\.block\.(\d+)\.(\d+)\.(.+)\.(weight|bias)$", k)
        if m:
            s, j, sub, leaf = m.groups()
            base = f"backbone.block{int(s) + 1}.{j}"
            if sub in ("attention.self.key", "attention.self.value"):
                kv_halves.setdefault((base, leaf), {})[sub.rsplit(".", 1)[1]] = value
            elif sub in _HF_BLOCK_RENAMES:
                out[f"{base}.{_HF_BLOCK_RENAMES[sub]}.{leaf}"] = value
            else:
                raise KeyError(f"unhandled HF SegFormer block key {key!r}")
            continue
        m = re.match(r"segformer\.encoder\.layer_norm\.(\d+)\.(weight|bias)$", k)
        if m:
            out[f"backbone.norm{int(m.group(1)) + 1}.{m.group(2)}"] = value
            continue
        m = re.match(r"decode_head\.linear_c\.(\d+)\.proj\.(weight|bias)$", k)
        if m:
            out[f"decode_head.linear_c{int(m.group(1)) + 1}.proj.{m.group(2)}"] = value
            continue
        if k == "decode_head.linear_fuse.weight":
            out["decode_head.linear_fuse.conv.weight"] = value
            continue
        m = re.match(r"decode_head\.batch_norm\.(weight|bias|running_mean|running_var)$", k)
        if m:
            out[f"decode_head.linear_fuse.bn.{m.group(1)}"] = value
            continue
        m = re.match(r"decode_head\.classifier\.(weight|bias)$", k)
        if m:
            out[f"decode_head.linear_pred.{m.group(1)}"] = value
            continue
        raise KeyError(f"unhandled HF SegFormer key {key!r}")
    for (base, leaf), halves in kv_halves.items():
        if set(halves) != {"key", "value"}:
            raise KeyError(f"{base}: HF checkpoint has only {sorted(halves)} of key/value {leaf}")
        out[f"{base}.attn.kv.{leaf}"] = torch.cat([halves["key"], halves["value"]], 0)
    return out


def port_state_dict(state: Mapping) -> dict:
    """Any ``.pth`` the port reads -> its weights under the port's names: a
    train state's ``state_dict``, a HuggingFace SegFormer renamed, then
    ``reference_to_port_state_dict``."""
    if "state_dict" in state:
        state = state["state_dict"]
    if is_hf_segformer_layout(state.keys()):
        state = hf_to_port_state_dict(state)
    return reference_to_port_state_dict(state)
