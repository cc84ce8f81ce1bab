"""Export the eval forward as one serving program, a ``torch.export`` ``.pt2``
(the port of ``hiast_tpu/cli/export_model.py``).

    python -m hiast_tpu_torch.cli.export_model --config_file configs/validate.yaml \\
        --validate_resume_from .../HIAST_final.pth \\
        --output model.pt2 --height 768 --width 1536 [--device cuda|cpu]

The program maps uint8 RGB images [b, H, W, 3] (b symbolic) to float32
per-pixel class logits [b, H, W, C], the JAX artifact's layout: the ImageNet
normalisation, the trunk under bf16 autocast and the align_corners bilinear
upsample are all inside it, as in ``selftrain/steps.py:make_eval_forward``.
The normalisation's mean and std, built on the input's device, are
constants of the program, so an artifact runs on the device it was exported
on (``--device``), as a JAX artifact runs on its ``platforms``.

Unlike JAX's StableHLO, the artifact is not self-contained: a SegFormer
program calls the port's registered op ``hiast_tpu_torch::sra_attention_kv``
(the SRA attention kernel on the card), so loading it needs this package
and, on the card, the kernel's build.  ``load_exported`` imports the op
before ``torch.export.load``.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from hiast_tpu_torch.cli.common import build_cfg, resolve_device, standard_parser
from hiast_tpu_torch.models.segmentors import build_segmentor
from hiast_tpu_torch.selftrain.steps import normalize_image
from hiast_tpu_torch.utils.checkpoint import load_weights

INIT_SEED = 0  # the initialisation a checkpoint then overwrites (JAX: PRNGKey(0))


class ServingForward(nn.Module):
    """uint8 [b, H, W, 3] -> float32 logits [b, H, W, C]: the eval forward of
    ``make_eval_forward`` without its ``inference_mode``, which an export
    cannot trace, and permuted to the JAX artifact's layout."""

    def __init__(self, segmentor):
        super().__init__()
        self.segmentor = segmentor
        self.trunk = segmentor.module  # registers the weights with this module

    def forward(self, images_uint8: torch.Tensor) -> torch.Tensor:
        logits = self.segmentor.forward(normalize_image(images_uint8), torch.bfloat16)["logits"]
        return logits.permute(0, 2, 3, 1)


def build_exported(cfg, height: int, width: int, device: torch.device | str,
                   weights: str | None = None) -> torch.export.ExportedProgram:
    """The eval forward of ``cfg``'s segmentor at ``height`` x ``width`` on
    ``device``, exported with a symbolic batch.  Weights from the
    checkpoint ``weights``, else the seeded initialisation."""
    device = torch.device(device)
    segmentor = build_segmentor(cfg)
    segmentor.module.init_weights(torch.Generator().manual_seed(INIT_SEED))
    if weights:
        load_weights(weights, segmentor.module)
    serve = ServingForward(segmentor).to(device).eval().requires_grad_(False)
    # two images at trace time: a batch of 1 would be specialised to 1
    example = torch.zeros((2, height, width, 3), dtype=torch.uint8, device=device)
    return torch.export.export(serve, (example,), dynamic_shapes=({0: torch.export.Dim("batch", min=1)},))


def load_exported(path: str) -> torch.export.ExportedProgram:
    """A program written by ``main``; its ``.module()`` is the callable."""
    import hiast_tpu_torch.ops.cuda.attention  # noqa: F401  registers hiast_tpu_torch::sra_attention_kv

    return torch.export.load(path)


def main(argv=None) -> torch.export.ExportedProgram:
    p = standard_parser(
        "hiast_tpu_torch torch.export serving export; the program runs on the --device it "
        "was exported on (its normalisation constants live there), and a SegFormer "
        "program needs this package to load (its attention is a registered op)"
    )
    p.add_argument("--output", required=True, help="output .pt2 path")
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=1536)
    args = p.parse_args(argv)
    cfg = build_cfg(args)
    device = resolve_device(args.device)
    # the trunk runs in bf16 under autocast; the resizes around it in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    program = build_exported(cfg, args.height, args.width, device, cfg.validate.resume_from)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    torch.export.save(program, args.output)
    nodes = {n.name: n.meta["val"] for n in program.graph.nodes if "val" in n.meta}
    signature = program.graph_signature

    def describe(names) -> list:
        return [(tuple(nodes[n].shape), nodes[n].dtype) for n in names]

    print(
        f"exported {cfg.model.seg_model.type} -> {args.output}: "
        f"{os.path.getsize(args.output) / 1e6:.1f} MB, device={device}, "
        f"in={describe(signature.user_inputs)}, out={describe(signature.user_outputs)}"
    )
    return program


if __name__ == "__main__":
    main()
