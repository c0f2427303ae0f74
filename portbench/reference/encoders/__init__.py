"""The configurations' node encoders, one file each, found by name: the
encoder of a configuration whose `model.backbone` is `b` is
`encoders/<b>.py`, and no table lists them.  A new encoder is a new file
here, and no edit.

Each file defines

* `MODULE`: the attribute of the program's `RelPoseGNN` that holds the
  encoder (`feature_extractor`, `encoder`), which is also the prefix of
  its parameter names;
* `spec(m) -> [(name, shape, kind), ...]`: its parameters, for model
  section `m`, named as the program's state dict names them (see
  `params.py` for the kinds);
* `forward(sd, m, x, prec, train=False) -> [B, feat]`: normalised images
  [B, H, W, 3] to node embeddings, plainly, rounding where `prec` says;

and may define `KINDS = {kind: fn(z, shape) -> tensor}`: initial
distributions of its own, each turning its slice of the spec's one
standard normal draw into the weight (`params.make_weights`).
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def find(backbone: str):
    """The encoder module of backbone `backbone`, loaded from its file."""
    name = f"{__name__}.{backbone}"
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join(HERE, backbone + ".py")
    if not os.path.isfile(path):
        raise LookupError(f"no node encoder for backbone {backbone!r}: "
                          f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.modules[name] = mod
    return mod
