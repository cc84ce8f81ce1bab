"""Component registries of the port.

The same public surface as the JAX package's registries (``DATASET['Cityscapes']``,
``PSEUDO_POLICY['IAS']``), kept as separate objects: both packages register
the reference names, and a registry raises on a duplicate name.
"""
from __future__ import annotations

from typing import Any


class Registry(dict):
    """A name -> component mapping with a ``register`` decorator."""

    def __init__(self, name: str):
        super().__init__()
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def register(self, key: str | None = None, obj: Any = None):
        if obj is not None:  # direct call: REG.register('name', thing)
            self._set(key, obj)
            return obj

        def decorator(fn_or_cls):
            self._set(key or fn_or_cls.__name__, fn_or_cls)
            return fn_or_cls

        return decorator

    def _set(self, key: str, obj: Any) -> None:
        if key in self:
            raise KeyError(f"{key!r} already registered in {self._name}")
        self[key] = obj

    def __missing__(self, key):
        known = ", ".join(sorted(self))
        raise KeyError(f"{key!r} not found in registry {self._name!r} (known: {known})")


DATASET = Registry("dataset")
LOSS = Registry("loss")
MODEL = Registry("model")
PREPROCESSOR = Registry("preprocessor")
PSEUDO_POLICY = Registry("pseudo_policy")
SEG_MODEL = Registry("seg_model")
TRAINER = Registry("trainer")


def populate() -> None:
    """Import every pluggable module of the port for its registrations."""
    import importlib

    for mod in (
        "hiast_tpu_torch.models.deeplab_v2",
        "hiast_tpu_torch.models.deeplab_v3plus",
        "hiast_tpu_torch.models.segformer",
        "hiast_tpu_torch.models.segmentors",
        "hiast_tpu_torch.data.datasets",
        "hiast_tpu_torch.data.copy_paste",
        "hiast_tpu_torch.pseudo.generator",
        "hiast_tpu_torch.ops.losses",
        "hiast_tpu_torch.selftrain.trainers",
    ):
        importlib.import_module(mod)
