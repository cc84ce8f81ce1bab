"""SegFormer (Mix Transformer encoder + all-MLP decode head), NCHW.

The port of ``hiast_tpu/models/segformer.py``.  Submodules are named as the
NVlabs / mmseg ``.pth`` layout that ``hiast_tpu/models/convert_segformer.py``
reads (``backbone.block3.17.attn.kv``, ``attn.norm`` for the spatial
reduction's LayerNorm, ``mlp.dwconv.dwconv``, ``decode_head.linear_fuse.conv``
without bias, ``decode_head.linear_fuse.bn``, ``decode_head.linear_pred``), so a
state_dict of this module IS the reference ``.pth`` layout.  Inside the
encoder the tokens are [B, N, C] as in the reference; the model takes and
returns NCHW.

The math is the JAX package's: every LayerNorm has eps 1e-6, Mix-FFN uses the
tanh approximation of GELU (flax's ``nn.gelu`` default; the published
SegFormer uses the exact erf form), attention runs through the SRA kernel
(``ops/cuda/attention.py``), and the head fuses per stage before it
upsamples (``LinearFuse``).  The attention takes q and the fused kv
projection, so under autograd its backward kernel writes the gradient of
``kv`` as one buffer.  In train mode the head's BatchNorm normalises with
batch statistics and updates its running ones, as the JAX model does with
``train=True``.

``remat_blocks`` (set by ``build_seg_model`` from ``runtime.remat`` and
``runtime.remat_mode``, ``deeplab_v2.remat_plan``) reruns each ``MiTBlock``
in the backward when the encoder trains under autograd (``models/remat.py``;
``save_dots`` keeps the Linear outputs), so a B5 training step launches the
attention kernel twice per block.  Parameter names do not change.

On image rows sharded over the ``space`` axis (``parallel/spatial.py``:
``convert_spatial`` and ``sharded_rows``) each rank's tokens are its slab's;
the convolutions read their halos, the head's resizes their source rows,
and each ``EfficientAttention`` gathers the spatially reduced K/V of every
slab, so the SRA kernel runs this rank's queries against the whole K/V.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hiast_tpu_torch.models.remat import checkpointed
from hiast_tpu_torch.ops.cuda.attention import sra_attention_kv
from hiast_tpu_torch.ops.resize import bilinear_resize
from hiast_tpu_torch.parallel import spatial
from hiast_tpu_torch.registry import SEG_MODEL

LN_EPS = 1e-6

VARIANTS = {
    # embed_dims, depths
    "B0": ((32, 64, 160, 256), (2, 2, 2, 2)),
    "B1": ((64, 128, 320, 512), (2, 2, 2, 2)),
    "B2": ((64, 128, 320, 512), (3, 4, 6, 3)),
    "B3": ((64, 128, 320, 512), (3, 4, 18, 3)),
    "B4": ((64, 128, 320, 512), (3, 8, 27, 3)),
    "B5": ((64, 128, 320, 512), (3, 6, 40, 3)),
}
NUM_HEADS = (1, 2, 5, 8)
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIOS = (4, 4, 4, 4)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


def _grid(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H*W, C] -> [B, C, H, W]."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, stride: int):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch, stride=stride, padding=patch // 2)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor):
        x = self.proj(x)
        h, w = x.shape[2:]
        return self.norm(_tokens(x)), h, w


class EfficientAttention(nn.Module):
    """Self-attention with spatially reduced K/V (SegFormer's SRA).  The k
    and v projections are one Linear, ``kv``, whose first half is k."""

    def __init__(self, dim: int, heads: int, sr: int):
        super().__init__()
        self.heads = heads
        self.sr_ratio = sr
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = nn.Conv2d(dim, dim, sr, stride=sr)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x).reshape(b, n, self.heads, d)
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.norm(_tokens(self.sr(_grid(x, h, w))))
        # on row slabs (parallel/spatial.py) the queries stay this rank's and
        # K/V come from every slab; the gather's backward sums the partial
        # d(kv) of each rank's queries
        kv_in = spatial.gather_rows(kv_in, dim=1)
        # the kernel reads the k and v halves of kv in place
        return self.proj(sra_attention_kv(q, self.kv(kv_in)).reshape(b, n, c))


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return _tokens(self.dwconv(_grid(x, h, w)))


class MixFFN(nn.Module):
    def __init__(self, dim: int, ratio: int):
        super().__init__()
        hidden = dim * ratio
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        y = F.gelu(self.dwconv(self.fc1(x), h, w), approximate="tanh")
        return self.fc2(y)


class MiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, sr: int, ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = EfficientAttention(dim, heads, sr)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MixFFN(dim, ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.mlp(self.norm2(x), h, w)


class MixTransformer(nn.Module):
    """The MiT encoder: four stages at strides 4, 8, 16, 32.
    ``remat_blocks`` reruns each block in the backward, keeping the Linear
    outputs with ``save_dots`` (the module docstring)."""

    def __init__(self, embed_dims: Sequence[int], depths: Sequence[int], remat_blocks: bool = False,
                 save_dots: bool = False):
        super().__init__()
        self.remat_blocks, self.save_dots = remat_blocks, save_dots
        in_ch = 3
        for s in range(4):
            patch, stride = (7, 4) if s == 0 else (3, 2)
            self.add_module(f"patch_embed{s + 1}", OverlapPatchEmbed(in_ch, embed_dims[s], patch, stride))
            self.add_module(f"block{s + 1}", nn.ModuleList(
                MiTBlock(embed_dims[s], NUM_HEADS[s], SR_RATIOS[s], MLP_RATIOS[s])
                for _ in range(depths[s])
            ))
            self.add_module(f"norm{s + 1}", nn.LayerNorm(embed_dims[s], eps=LN_EPS))
            in_ch = embed_dims[s]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        remat = self.remat_blocks and self.training and torch.is_grad_enabled()
        feats = []
        for s in range(1, 5):
            x, h, w = getattr(self, f"patch_embed{s}")(x)
            for block in getattr(self, f"block{s}"):
                if remat:
                    x = checkpointed(block, x, h, w, save_dots=self.save_dots)
                else:
                    x = block(x, h, w)
            x = _grid(getattr(self, f"norm{s}")(x), h, w)
            feats.append(x)
        return feats


class MLP(nn.Module):
    """One stage's projection to the head width (reference name ``proj``)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.proj = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class LinearFuse(nn.Module):
    """The head's fuse 1x1 conv (no bias) and its BatchNorm.

    The kernel keeps the reference's concat layout [E, 4E, 1, 1], but, as in
    the JAX package, each stage's block of it is applied at that stage's own
    grid and the results are upsampled (``align_corners=False``) and summed,
    deepest stage first: a 1x1 conv commutes with bilinear interpolation, so
    this equals fuse(concat(up(c4), .., up(c1))) without the 4E-channel
    concat at stride 4."""

    def __init__(self, embed_dim: int, n_stages: int = 4):
        super().__init__()
        self.conv = nn.Conv2d(n_stages * embed_dim, embed_dim, 1, bias=False)
        self.bn = nn.BatchNorm2d(embed_dim, eps=1e-5, momentum=0.1)

    def forward(self, parts: list[torch.Tensor], out_hw: tuple[int, int]) -> torch.Tensor:
        """parts: per-stage tokens [B, h_i*w_i, E] with their grids, in concat
        order (deepest stage first); returns the fused [B, E, *out_hw]."""
        w_all = self.conv.weight[:, :, 0, 0]
        x, off = None, 0
        for tokens, (h, w) in parts:
            z = _grid(F.linear(tokens, w_all[:, off:off + tokens.shape[-1]]), h, w)
            off += tokens.shape[-1]
            z = bilinear_resize(z, *out_hw, align_corners=False)
            x = z if x is None else x + z
        return self.bn(x)


class SegFormerHead(nn.Module):
    """All-MLP decode head: per-stage projection -> fuse -> BN -> ReLU ->
    classifier, at stride 4."""

    def __init__(self, in_dims: Sequence[int], num_classes: int, embed_dim: int = 768):
        super().__init__()
        for i, dim in enumerate(in_dims):
            self.add_module(f"linear_c{i + 1}", MLP(dim, embed_dim))
        self.linear_fuse = LinearFuse(embed_dim, len(in_dims))
        self.linear_pred = nn.Conv2d(embed_dim, num_classes, 1)

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        parts = [
            (getattr(self, f"linear_c{i + 1}")(_tokens(f)), tuple(f.shape[2:]))
            for i, f in enumerate(feats)
        ]
        x = self.linear_fuse(parts[::-1], tuple(feats[0].shape[2:]))
        return self.linear_pred(F.relu(x))


class SegFormer(nn.Module):
    """Full model with the seg_model interface ({'logits', 'backbone'});
    logits at stride 4."""

    row_stride = 32  # the rows each slab of the ``space`` axis is a multiple of: the deepest stage's stride

    def __init__(self, num_classes: int = 19, variant: str = "B5", remat_blocks: bool = False,
                 save_dots: bool = False):
        super().__init__()
        embed_dims, depths = VARIANTS[variant]
        self.variant = variant
        self.backbone = MixTransformer(embed_dims, depths, remat_blocks, save_dots)
        head_dim = 256 if variant == "B0" else 768
        self.decode_head = SegFormerHead(embed_dims, num_classes, head_dim)

    def forward(self, x: torch.Tensor) -> dict:
        feats = self.backbone(x)
        return {"logits": self.decode_head(feats), "backbone": feats[-1]}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random initialisation drawn from ``generator``, the MiT
        scheme: trunc-normal(0.02) Linears, identity LayerNorm and BatchNorm,
        fan-out normal convs, zero biases.  On B5 at 128x256 this gives
        logits of std 4 and a mean confidence of 0.69 (0.39 to 0.97 between
        the 10th and 90th percentiles): the range of a trained model, so
        IAS thresholds and selections are not degenerate."""
        for m in self.modules():
            if isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()  # identity; BatchNorm's running stats too
                continue
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
            elif isinstance(m, nn.Conv2d):
                fan_out = m.kernel_size[0] * m.kernel_size[1] * m.out_channels // m.groups
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * (2.0 / fan_out) ** 0.5)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()


def _make_variant_factory(variant: str):
    def factory(num_classes: int = 19, output_dim: int = 256, remat_blocks: bool = False, save_dots: bool = False,
                **_ignored) -> SegFormer:
        """``output_dim`` and ``backbone_layers`` are accepted for the
        seg_model interface and ignored, as in the JAX factory."""
        return SegFormer(num_classes=num_classes, variant=variant, remat_blocks=remat_blocks, save_dots=save_dots)

    factory.row_stride = SegFormer.row_stride
    return factory


for _variant in VARIANTS:
    SEG_MODEL.register(f"SegFormer_{_variant}", _make_variant_factory(_variant))
