"""Generate dataset manifests by scanning the standard directory layouts
(the port's copy of ``hiast_tpu/cli/make_manifests.py``; its JSON is the
same, byte for byte).

The reference ships static JSON manifests (`data/*.json`,
[{image_name, mask_name}, ...]); this tool regenerates them from a dataset
root, so users don't need the reference checkout.

    python -m hiast_tpu_torch.cli.make_manifests --dataset cityscapes \
        --root /data/cityscapes --split train --output data/cityscapes_train.json
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def cityscapes_entries(root: str, split: str):
    img_dir = os.path.join(root, "leftImg8bit", split)
    entries = []
    for img in sorted(glob.glob(os.path.join(img_dir, "*", "*_leftImg8bit.png"))):
        rel = os.path.relpath(img, root)
        city = rel.split(os.sep)[2]
        mask_name = os.path.basename(img).replace(
            "_leftImg8bit.png", "_gtFine_labelTrainIds.png"
        )
        mask = os.path.join("gtFine", split, city, mask_name)
        entries.append({"image_name": rel, "mask_name": mask})
    return entries


def gtav_entries(root: str, split: str):
    entries = []
    for img in sorted(glob.glob(os.path.join(root, "images", "*.png"))):
        name = os.path.basename(img)
        entries.append(
            {"image_name": f"images/{name}", "mask_name": f"labels/{name}"}
        )
    return entries


def synthia_entries(root: str, split: str):
    entries = []
    for img in sorted(glob.glob(os.path.join(root, "RGB", "*.png"))):
        name = os.path.basename(img)
        entries.append({"image_name": f"RGB/{name}", "mask_name": f"GT/LABELS/{name}"})
    return entries


def oxford_entries(root: str, split: str):
    entries = []
    img_dir = os.path.join(root, split)
    for img in sorted(glob.glob(os.path.join(img_dir, "*.png"))):
        name = os.path.basename(img)
        if split == "train":  # unlabeled
            entries.append({"image_name": f"{split}/{name}", "mask_name": f"{split}/{name}.nolabel"})
        else:
            entries.append({"image_name": f"{split}/{name}", "mask_name": f"{split}_anno/{name}"})
    return entries


BUILDERS = {
    "cityscapes": cityscapes_entries,
    "gtav": gtav_entries,
    "synthia": synthia_entries,
    "oxford": oxford_entries,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="hiast_tpu_torch manifest generator")
    p.add_argument("--dataset", required=True, choices=sorted(BUILDERS))
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    entries = BUILDERS[args.dataset](args.root, args.split)
    if not entries:
        raise SystemExit(f"no images found under {args.root} for {args.dataset}/{args.split}")
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(entries, f)
    print(f"wrote {len(entries)} entries to {args.output}")


if __name__ == "__main__":
    main()
