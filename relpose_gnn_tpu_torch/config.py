"""The whole configuration tree with a JSON round trip.

Port of `relpose_gnn_tpu/config.py`: one dataclass over the port's own
`ExperimentConfig`, `TrainerConfig`, `RelPoseGNNConfig` and
`GraphBuilderConfig`, saved to and loaded from one JSON file:

    cfg = FrameworkConfig(experiment=..., trainer=..., model=...)
    cfg.save("run.json");  cfg = FrameworkConfig.load("run.json")

The file is the JAX package's: each package loads the other's.  Dtypes
travel as strings.  The port writes a torch dtype by its name
("bfloat16"), which the JAX loader maps to `jnp.bfloat16`; it reads the
JAX package's strings "<class 'jax.numpy.bfloat16'>" and "bfloat16" as
bfloat16 and any other as float32, as the JAX loader does: the model's
`dtype` becomes `torch.bfloat16` or None, a string field named `dtype`
(the experiment's) "bfloat16" or "float32".  Keys one package has and the
other lacks are skipped on load; lists become tuples where the field's
default is a tuple.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import torch

from relpose_gnn_tpu_torch.data.graph_builder import GraphBuilderConfig
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNNConfig
from relpose_gnn_tpu_torch.training.experiment import ExperimentConfig
from relpose_gnn_tpu_torch.training.trainer import TrainerConfig

_BF16_NAMES = ("<class 'jax.numpy.bfloat16'>", "bfloat16")


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    if isinstance(obj, torch.dtype):
        return str(obj).removeprefix("torch.")
    return obj


def _dtype(value, field: dataclasses.Field):
    """A serialised dtype for `field`: a string field keeps a name, any
    other takes torch.bfloat16 or None (float32)."""
    bf16 = str(value) in _BF16_NAMES
    if isinstance(field.default, str):
        return "bfloat16" if bf16 else "float32"
    return torch.bfloat16 if bf16 else None


@dataclasses.dataclass
class FrameworkConfig:
    experiment: ExperimentConfig = dataclasses.field(
        default_factory=ExperimentConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    model: RelPoseGNNConfig = dataclasses.field(
        default_factory=RelPoseGNNConfig)
    builder: GraphBuilderConfig = dataclasses.field(
        default_factory=GraphBuilderConfig)

    def to_dict(self) -> dict:
        return _asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "FrameworkConfig":
        with open(path) as f:
            d = json.load(f)

        def build(tcls, sub):
            fields = {f.name: f for f in dataclasses.fields(tcls)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    continue
                if k == "dtype":
                    v = _dtype(v, fields[k])
                elif isinstance(fields[k].default, tuple) and \
                        isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return tcls(**kwargs)

        return cls(experiment=build(ExperimentConfig, d["experiment"]),
                   trainer=build(TrainerConfig, d["trainer"]),
                   model=build(RelPoseGNNConfig, d["model"]),
                   builder=build(GraphBuilderConfig, d["builder"]))
