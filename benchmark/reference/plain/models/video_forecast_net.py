"""Context network for ego-forecast (counterpart of
egopose_tpu/models/video_forecast_net.py).

The context is the final hidden state of a causal LSTM or TCN over only the
``v_margin`` past video frames, fixed for the episode, joined with an
optional per-step state LSTM (``s_net_type`` ``lstm``; ``id`` passes the
state through):

- ``encode_video(windows)``: (B, W, feat) -> (B, v_hdim)
- ``s_step(carry, state)``: one state-LSTM step (the rollout's step loop)
- ``s_batch(states)``: (T, B, state_dim) -> (T, B, s_dim) (the update)
- ``context(windows, states)``: the update's network input (T, B, out_dim)
"""
from __future__ import annotations

import torch
from torch import nn

from .rnn import RNN


class VideoForecastNet(nn.Module):
    def __init__(self, cnn_feat_dim: int, state_dim: int, v_hdim: int = 128,
                 v_margin: int = 10, v_net_type: str = "lstm",
                 s_hdim: int | None = None, s_net_type: str = "id",
                 dynamic_v: bool = False, v_net_param: dict | None = None):
        super().__init__()
        if dynamic_v:
            # the JAX sampler indexes the per-step context at t in an empty
            # (B, 0, v_hdim) unroll, since its windows hold only v_margin
            # frames, and raises IndexError (ROADMAP §3)
            raise NotImplementedError(
                "dynamic_v: the JAX reference cannot run it (its windows "
                "hold only the v_margin past frames); see ROADMAP §3")
        self.v_margin = v_margin
        self.s_net_type = s_net_type
        self.v_hdim = v_hdim
        self.s_dim = state_dim if s_hdim is None else s_hdim
        self.out_dim = v_hdim + self.s_dim
        self.v_net_type = v_net_type
        if v_net_type == "lstm":
            self.v_net = RNN(cnn_feat_dim, v_hdim)
        elif v_net_type == "tcn":
            raise NotImplementedError("the reference holds the LSTM context nets only")
        else:
            raise ValueError(v_net_type)
        if s_net_type == "lstm":
            self.s_net = RNN(state_dim, self.s_dim)

    def encode_video(self, windows: torch.Tensor) -> torch.Tensor:
        """(B, W, feat) past-frame windows -> (B, v_hdim), the causal
        net's output at the last frame."""
        if self.v_net_type == "lstm":
            return self.v_net(windows.transpose(0, 1))[-1]
        return self.v_net(windows)[:, -1]

    def s_init_carry(self, batch_shape, like: torch.Tensor):
        """The state LSTM's zero carry (``()`` without one)."""
        if self.s_net_type != "lstm":
            return ()
        return self.s_net.init_carry(batch_shape, like)

    def s_step(self, carry, state: torch.Tensor):
        """One state-LSTM step: (carry, (B, state_dim)) -> (carry, (B,
        s_dim))."""
        if self.s_net_type != "lstm":
            return carry, state
        return self.s_net.step(carry, state)

    def s_batch(self, states: torch.Tensor) -> torch.Tensor:
        """(T, B, state_dim) -> (T, B, s_dim), the state LSTM unrolled."""
        if self.s_net_type != "lstm":
            return states
        return self.s_net(states)

    def context(self, windows: torch.Tensor,
                states: torch.Tensor) -> torch.Tensor:
        """Network input (T, B, out_dim): the episode's video context
        broadcast over T, joined with ``s_batch(states)``."""
        v = self.encode_video(windows)
        v = v.unsqueeze(0).expand((states.shape[0],) + v.shape)
        return torch.cat([v, self.s_batch(states)], -1)
