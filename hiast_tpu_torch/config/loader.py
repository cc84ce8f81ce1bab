"""Three-level config layering: defaults < config_file < setting_file < CLI.

Mirrors the reference's layering contract (reference: code/train.py:31-63,
code/validate.py:20-39): the ``setting_file`` overlay is how one YAML
(``hiast_setting.yaml``) upgrades plain self-training rounds into HIAST
rounds.  Unknown keys from the reference's GPU-era schema (``apex_opt``,
``gpu_num``, ``port``) are accepted and dropped with a warning so the
reference's own YAML files load unchanged.
"""
from __future__ import annotations

import warnings
from typing import Any, Mapping

from hiast_tpu_torch.config import yaml_subset
from hiast_tpu_torch.config.node import ConfigNode
from hiast_tpu_torch.config.schema import default_config

# Reference-era keys with no TPU meaning; silently portable.
_LEGACY_KEYS = {
    "train.apex_opt",
    "train.gpu_num",
    "train.port",
}

# Reference keys whose mechanism is superseded by a TPU-native redesign:
# accepted for compatibility, dropped with a pointer at the replacement.
_SUPERSEDED_KEYS = {
    "pseudo_policy.cbst.sample_interval": (
        "CBST quantiles are computed exactly on device via histograms "
        "(pseudo_policy.num_hist_bins); the host-side probability-store "
        "sampling interval has no effect"
    ),
}


def _strip_legacy(tree: Mapping[str, Any], prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if path in _LEGACY_KEYS:
            warnings.warn(f"dropping legacy (GPU-era) config key {path!r}")
            continue
        if path in _SUPERSEDED_KEYS:
            warnings.warn(
                f"dropping superseded config key {path!r}: {_SUPERSEDED_KEYS[path]}"
            )
            continue
        out[k] = _strip_legacy(v, path + ".") if isinstance(v, Mapping) else v
    return out


def load_yaml(path: str) -> dict:
    """The mapping in a config file, read by the port's own reader of the
    YAML subset the configs use (``yaml_subset``): one path on every
    machine, the card's included, which has no YAML package."""
    return yaml_subset.load(path) or {}


def load_config(
    config_file: str | None = None,
    setting_file: str | None = None,
    overrides: list | None = None,
    freeze: bool = True,
) -> ConfigNode:
    cfg = default_config()
    if config_file:
        cfg.merge_from_dict(_strip_legacy(load_yaml(config_file)))
    if setting_file:
        cfg.merge_from_dict(_strip_legacy(load_yaml(setting_file)))
    if overrides:
        cfg.merge_from_list(overrides)
    if freeze:
        cfg.freeze()
    return cfg


def apply_cli_overrides(cfg: ConfigNode, args) -> ConfigNode:
    """Apply the standard CLI flags (reference: code/train.py:40-56)."""
    pairs = []
    if getattr(args, "resume_from", None):
        pairs += ["train.resume_from", args.resume_from]
    if getattr(args, "pseudo_resume_from", None):
        pairs += ["pseudo_policy.resume_from", args.pseudo_resume_from]
    if getattr(args, "pseudo_save_dir", None):
        pairs += [
            "pseudo_policy.save_dir", args.pseudo_save_dir,
            "dataset.target.pseudo_dir", args.pseudo_save_dir,
        ]
    if getattr(args, "work_dir", None):
        pairs += ["work_dir", args.work_dir]
    if getattr(args, "seg_model", None):
        pairs += ["model.seg_model.type", args.seg_model]
    if getattr(args, "validate_resume_from", None):
        pairs += ["validate.resume_from", args.validate_resume_from]
    if pairs:
        cfg.merge_from_list(pairs)
    return cfg
