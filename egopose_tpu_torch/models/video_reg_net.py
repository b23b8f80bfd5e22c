"""VideoRegNet: the state-regression model (counterpart of
egopose_tpu/models/video_reg_net.py).

video frames (or precomputed CNN features when ``no_cnn``) -> per-frame
CNN features -> temporal net (bi-LSTM, or causal LSTM, or TCN) -> MLP ->
linear state output.  Sequences are time-major (T, B, ...) as in the JAX
package; frames arrive NHWC from the dataset and are permuted to NCHW on
the device.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .mlp import MLP
from .mobile_net import MobileNet
from .resnet import ResNet18
from .rnn import RNN
from .tcn import make_tcn


class VideoRegNet(nn.Module):
    def __init__(self, out_dim: int, v_hdim: int = 128, cnn_fdim: int = 128,
                 no_cnn: bool = False, frame_shape=(224, 224, 3),
                 mlp_dim: Sequence[int] = (300, 200),
                 cnn_type: str = "resnet", v_net_type: str = "lstm",
                 v_net_param: dict | None = None, causal: bool = False):
        super().__init__()
        self.cnn_fdim = cnn_fdim
        self.frame_shape = tuple(frame_shape)
        self.v_net_type = v_net_type
        self.v_hdim, self.v_net_param, self.causal = v_hdim, v_net_param, \
            causal
        if no_cnn:
            self.cnn = None
        elif cnn_type == "resnet":
            self.cnn = ResNet18(cnn_fdim, self.frame_shape[-1])
        elif cnn_type == "mobile":
            self.cnn = MobileNet(cnn_fdim, self.frame_shape[-1])
        else:
            raise ValueError(cnn_type)
        if v_net_type == "lstm":
            self.v_net = RNN(cnn_fdim, v_hdim, bi_dir=not causal)
        elif v_net_type == "tcn":
            self.v_net = make_tcn(cnn_fdim, v_hdim, v_net_param, causal)
        else:
            raise ValueError(v_net_type)
        self.mlp = MLP(v_hdim, mlp_dim, "relu")
        self.linear = nn.Linear(self.mlp.out_dim, out_dim)

    def cnn_feature(self, frames: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) frames -> (N, cnn_fdim) features."""
        return self.cnn(frames.permute(0, 3, 1, 2))

    def temporal(self, feats: torch.Tensor,
                 t_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(T, B, cnn_fdim) features -> (T, B, out_dim): the temporal net,
        the MLP and the linear head; ``t_mask`` (T,) as in the TCN
        (parallel/seqpar.py)."""
        if self.v_net_type == "lstm":
            h = self.v_net(feats)
        else:
            h = self.v_net(feats.transpose(0, 1), t_mask).transpose(0, 1)
        return self.linear(self.mlp(h))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(T, B, H, W, C) frames -> (T, B, cnn_fdim); identity without a
        CNN.  The CNN sees all T*B frames as one batch, as in the JAX
        package (its BatchNorm statistics run over them all)."""
        if self.cnn is None:
            return x
        t, b = x.shape[:2]
        return self.cnn_feature(x.reshape((t * b,) + self.frame_shape)) \
            .reshape(t, b, self.cnn_fdim)

    def forward(self, x: torch.Tensor,
                t_mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: (T, B, H, W, C) frames, or (T, B, cnn_fdim) when no_cnn ->
        (T, B, out_dim)."""
        return self.temporal(self.features(x), t_mask)
