"""Absolute-pose baselines (PyTorch): PoseNet, MapNet, AtLoc(+) and the
four-directional LSTM.

Port of `relpose_gnn_tpu/models/atloc.py` (reference modules/att.py:37-133,
modules/posenet.py:39-105).  All share the ResNet34 trunk (`encoder`,
torchvision names inside; mean pool + `Linear(512, feat_dim)`) and regress
pose6 = [t(3), logq(3)] ([t(3), q(4)] for PoseNetNoLog).  Images are NHWC
[B, H, W, 3]; the sequence models take [B, T, H, W, 3] and apply the
single-frame model to each frame.

Dropout is flax's (models/posenet.py::dropout): active with `train=True`,
or at eval with `eval_dropout=True` (the reference's quirk), its mask
drawn from the `generator` the caller passes.

`FourDirectionalLSTM` holds flax's `OptimizedLSTMCell`s in two
bidirectional `nn.LSTM`s (cuDNN on the card), `rightleft` and `downup`.
flax's cell has input kernels ii/if/ig/io with NO bias and hidden
kernels hi/hf/hg/ho WITH one, gates in the order i, f, g, o, and a zero
initial carry: the same function as torch's LSTM with `bias_ih` = 0 and
`bias_hh` = flax's bias (models/convert.py::zoo_state_dict_from_jax lays
them out so).  flax's `RNN(reverse=True)` returns its outputs in
processing order, so the JAX module's `[:, -1]` is the backward pass's
final hidden state, `h_n[1]` of the bidirectional LSTM.  With
`random_init=True` the initial carry (c, then h, shared by both
directions, as in the JAX module) is drawn from the `generator` the caller
passes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from relpose_gnn_tpu_torch.models.attention import AttentionBlock
from relpose_gnn_tpu_torch.models.dense import dense
from relpose_gnn_tpu_torch.models.posenet import dropout
from relpose_gnn_tpu_torch.models.resnet import ResNet

RESNET34 = (3, 4, 6, 3)


class FourDirectionalLSTM(nn.Module):
    """[B, origin_feat_size] -> [B, 4 hidden]: the feature vector folded
    to [seq, feat] is scanned left-right and (transposed) up-down by
    bidirectional LSTMs; the four final hidden states concatenate."""

    def __init__(self, seq_size: int = 32, origin_feat_size: int = 2048,
                 hidden_size: int = 256, random_init: bool = False):
        super().__init__()
        self.seq_size, self.hidden_size = seq_size, hidden_size
        self.random_init = random_init
        self.feat = origin_feat_size // seq_size
        self.rightleft = nn.LSTM(self.feat, hidden_size, batch_first=True,
                                 bidirectional=True)
        self.downup = nn.LSTM(seq_size, hidden_size, batch_first=True,
                              bidirectional=True)

    def _carry(self, b: int, generator: torch.Generator | None, device):
        if not self.random_init:
            return None
        if generator is None:
            raise ValueError("random_init=True draws the initial carry and "
                             "needs a torch.Generator")
        shape = (b, self.hidden_size)
        c, h = (torch.randn(shape, generator=generator,
                            device=generator.device).to(device)
                for _ in range(2))
        return h.expand(2, *shape).contiguous(), c.expand(2, *shape
                                                          ).contiguous()

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b = x.shape[0]
        x_rl = x.float().reshape(b, self.seq_size, self.feat)
        x_du = x_rl.transpose(1, 2).contiguous()
        out = []
        for lstm, seq in ((self.rightleft, x_rl), (self.downup, x_du)):
            _, (h_n, _) = lstm(seq, self._carry(b, generator, x.device))
            out += [h_n[0], h_n[1]]        # forward, backward final hidden
        return torch.cat(out, dim=1)


class PoseNet(nn.Module):
    """Backbone -> relu -> dropout -> heads (posenet.py:39-76);
    `quat_dim` 3 (logq) or 4 (PoseNetNoLog's quaternion head)."""

    quat_dim = 3

    def __init__(self, feat_dim: int = 2048, droprate: float = 0.5,
                 eval_dropout: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.droprate, self.eval_dropout = droprate, eval_dropout
        self.encoder = ResNet(RESNET34, feat_dim, dtype=dtype)
        self.fc_xyz = nn.Linear(feat_dim, 3)
        self.fc_wpqr = nn.Linear(feat_dim, self.quat_dim)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.encoder(images, train))
        if self.droprate > 0 and (train or self.eval_dropout):
            x = dropout(x, self.droprate, generator)
        return torch.cat([dense(x, self.fc_xyz), dense(x, self.fc_wpqr)],
                         dim=1)


class PoseNetNoLog(PoseNet):
    """`PoseNet_nolog` (posenet.py:1258): predicts [t(3), q(4)]."""

    quat_dim = 4


class MapNet(nn.Module):
    """PoseNet applied to each frame of [B, T, H, W, 3] -> [B, T, 6]
    (posenet.py:79-105; the reference's `view(N, 3, 256, -1)`, which
    folds the frames into the width axis, is the JAX module's documented
    non-replication)."""

    def __init__(self, feat_dim: int = 2048, droprate: float = 0.5,
                 eval_dropout: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.posenet = PoseNet(feat_dim, droprate, eval_dropout, dtype)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, t = images.shape[:2]
        poses = self.posenet(images.reshape((b * t,) + images.shape[2:]),
                             train, generator)
        return poses.reshape(b, t, 6)


class AtLoc(nn.Module):
    """Backbone -> relu -> AttentionBlock (or the four-directional LSTM)
    -> dropout -> heads (att.py:67-120).  The attention block runs the
    attention core (the CUDA kernel on the card) on E = B rows of C =
    feat_dim / 8, in float32 (the JAX block has no compute dtype)."""

    def __init__(self, feat_dim: int = 2048, droprate: float = 0.5,
                 eval_dropout: bool = False, lstm: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.droprate, self.eval_dropout = droprate, eval_dropout
        self.lstm = lstm
        self.encoder = ResNet(RESNET34, feat_dim, dtype=dtype)
        if lstm:
            self.lstm4dir = FourDirectionalLSTM(32, feat_dim, 256)
            head_in = 4 * 256
        else:
            self.att = AttentionBlock(feat_dim)
            head_in = feat_dim
        self.fc_xyz = nn.Linear(head_in, 3)
        self.fc_wpqr = nn.Linear(head_in, 3)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.encoder(images, train))
        x = self.lstm4dir(x, generator) if self.lstm else self.att(x)
        if self.droprate > 0 and (train or self.eval_dropout):
            x = dropout(x, self.droprate, generator)
        return torch.cat([dense(x, self.fc_xyz), dense(x, self.fc_wpqr)],
                         dim=1)


class AtLocPlus(nn.Module):
    """AtLoc applied to each frame of [B, T, H, W, 3] -> [B, T, 6]
    (att.py:123-133)."""

    def __init__(self, feat_dim: int = 2048, droprate: float = 0.5,
                 eval_dropout: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.atloc = AtLoc(feat_dim, droprate, eval_dropout, dtype=dtype)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, t = images.shape[:2]
        poses = self.atloc(images.reshape((b * t,) + images.shape[2:]),
                           train, generator)
        return poses.reshape(b, t, 6)
