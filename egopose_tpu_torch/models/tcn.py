"""Temporal convolutional network (counterpart of egopose_tpu/models/tcn.py):
weight-normalised dilated residual Conv1d blocks, dilation 2^i, with
``causal`` (left-only) or symmetric padding.

The interface keeps the JAX package's (batch, time, channels) layout; the
convolutions run on (batch, channels, time) inside.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# flax's WeightNorm divides by sqrt(sum v^2 + 1e-12) (normalization.py
# _l2_normalize), over every axis but the output one
WN_EPS = 1e-12


class WeightNormConv1d(nn.Module):
    """Conv1d with weight = weight_g * weight_v / ||weight_v||, the norm
    taken per output channel (over input channels and taps).  The
    parameters keep torch's weight_norm names: ``weight_v`` (out, in, k),
    ``weight_g`` (out, 1, 1), ``bias``."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        # the JAX package's init: normal(0, 0.01) kernel, unit scale
        self.weight_v = nn.Parameter(
            torch.randn(n_out, n_in, kernel_size) * 0.01)
        self.weight_g = nn.Parameter(torch.ones(n_out, 1, 1))
        self.bias = nn.Parameter(torch.zeros(n_out))

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return v * torch.rsqrt((v * v).sum((1, 2), keepdim=True) + WN_EPS) \
            * self.weight_g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight(), self.bias, dilation=self.dilation)


class TemporalBlock(nn.Module):
    def __init__(self, n_in: int, n_out: int, kernel_size: int,
                 dilation: int, dropout: float, causal: bool):
        super().__init__()
        pad = (kernel_size - 1) * dilation
        self.padding = (pad, 0) if causal else (pad // 2, pad // 2)
        self.conv1 = WeightNormConv1d(n_in, n_out, kernel_size, dilation)
        self.conv2 = WeightNormConv1d(n_out, n_out, kernel_size, dilation)
        self.p = dropout
        if n_in != n_out:
            self.downsample = nn.Conv1d(n_in, n_out, 1)
            nn.init.normal_(self.downsample.weight, 0.0, 0.01)
            nn.init.zeros_(self.downsample.bias)
        else:
            self.downsample = None

    def dropout(self, v: torch.Tensor, lanes) -> torch.Tensor:
        """Dropout in training mode.  The keep mask is drawn for
        ``lanes`` = (all lanes, this shard's first) and sliced, so a
        data-parallel rank draws its slice of the one-process mask."""
        if not (self.training and self.p > 0):
            return v
        n_all, first = lanes or (v.shape[0], 0)
        keep = torch.empty((n_all,) + v.shape[1:], dtype=v.dtype,
                           device=v.device).bernoulli_(1 - self.p)
        return v * keep[first:first + v.shape[0]] / (1 - self.p)

    def forward(self, x: torch.Tensor, t_mask: torch.Tensor | None = None,
                lanes=None) -> torch.Tensor:
        """(B, C, T) -> (B, C', T).  ``t_mask`` (T,) zeroes positions
        outside the true sequence after each neighbourhood op, so that a
        time shard's fake edge frames read as the convolutions' own zero
        padding (parallel/seqpar.py)."""
        msk = (lambda v: v * t_mask) if t_mask is not None \
            else (lambda v: v)
        out = self.dropout(msk(torch.relu(self.conv1(F.pad(x,
                                                           self.padding)))),
                           lanes)
        out = self.dropout(torch.relu(self.conv2(F.pad(out, self.padding))),
                           lanes)
        res = x if self.downsample is None else self.downsample(x)
        return msk(torch.relu(out + res))


class TemporalConvNet(nn.Module):
    """Stack of TemporalBlocks ``block0``, ``block1``, ... (the JAX
    package's names) with dilation 2^i.  ``lanes`` (all lanes, this
    shard's first), when set, makes the dropout masks those of the whole
    batch (TemporalBlock.dropout)."""

    def __init__(self, n_in: int, num_channels: Sequence[int],
                 kernel_size: int = 3, dropout: float = 0.2,
                 causal: bool = False):
        super().__init__()
        assert kernel_size % 2 == 1
        self.n_blocks = len(num_channels)
        self.lanes = None
        for i, ch in enumerate(num_channels):
            self.add_module(f"block{i}", TemporalBlock(
                n_in, ch, kernel_size, 2 ** i, dropout, causal))
            n_in = ch

    def forward(self, x: torch.Tensor,
                t_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B, T, C) -> (B, T, num_channels[-1]); ``t_mask`` (T,) as in
        TemporalBlock, applied to the input too."""
        x = x.transpose(1, 2)
        if t_mask is not None:
            x = x * t_mask
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, t_mask, self.lanes)
        return x.transpose(1, 2)


def make_tcn(n_in: int, v_hdim: int, param: dict | None,
             causal: bool) -> TemporalConvNet:
    """A context or regression net's TCN from its ``v_net_param`` (size,
    kernel_size, dropout; the JAX package's defaults [64, 128], 3, 0.2)."""
    param = param or {}
    size = param.get("size", [64, 128])
    assert size[-1] == v_hdim
    return TemporalConvNet(n_in, size, param.get("kernel_size", 3),
                           param.get("dropout", 0.2), causal)
