"""Video context network for ego-mimic (counterpart of
egopose_tpu/models/video_state_net.py): encode a window of per-frame CNN
features into per-step context vectors with an LSTM (bidirectional unless
``causal``) or a TCN, trimming ``v_margin`` frames on both sides."""
from __future__ import annotations

import torch
from torch import nn

from .rnn import RNN
from .tcn import make_tcn


class VideoStateNet(nn.Module):
    def __init__(self, cnn_feat_dim: int, v_hdim: int = 128,
                 v_margin: int = 10, v_net_type: str = "lstm",
                 causal: bool = False, v_net_param: dict | None = None):
        super().__init__()
        self.v_margin = v_margin
        self.causal = causal
        self.v_net_type = v_net_type
        self.v_hdim, self.v_net_param = v_hdim, v_net_param
        if v_net_type == "lstm":
            self.v_net = RNN(cnn_feat_dim, v_hdim, bi_dir=not causal)
        elif v_net_type == "tcn":
            self.v_net = make_tcn(cnn_feat_dim, v_hdim, v_net_param, causal)
        else:
            raise ValueError(v_net_type)

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        """(N, W, feat) windows -> (N, W - 2*v_margin, v_hdim) context."""
        if self.v_net_type == "lstm":
            out = self.v_net(windows.transpose(0, 1)).transpose(0, 1)
        else:
            out = self.v_net(windows)
        return out[:, self.v_margin:-self.v_margin]

    def encode_raw(self, windows: torch.Tensor,
                   t_mask: torch.Tensor | None = None) -> torch.Tensor:
        """The inner TCN alone over (N, W, feat) windows, no margin
        trimmed, positions outside ``t_mask`` kept zero: the time-sharded
        encode's per-shard pass (parallel/seqpar.py)."""
        return self.v_net(windows, t_mask)

    def context(self, windows: torch.Tensor,
                states: torch.Tensor) -> torch.Tensor:
        """Network input (T, B, v_hdim + obs): each step's context from the
        lane's window, joined with the recorded states."""
        return torch.cat([self(windows).transpose(0, 1), states], -1)

    def causal_encode(self, feats: torch.Tensor) -> torch.Tensor:
        """Online-inference context: at step t the net sees video up to
        frame t + 2*v_margin.  The forward pass is the full pass; the
        backward pass restarts from a zero carry v_margin frames ahead of
        each output position (equal to the reference's per-step
        recomputation, in O(T * v_margin)).  A causal net's full pass is
        its answer; a non-causal TCN raises, as in the JAX package."""
        m = self.v_margin
        if self.causal:
            return self(feats)
        if self.v_net_type != "lstm":
            raise NotImplementedError(
                "--causal with a non-causal TCN context net would need the "
                "reference's per-prefix recomputation; use causal: true")
        x = feats.transpose(0, 1)                  # (T, N, F)
        t_len, n = x.shape[0], x.shape[1]
        l_out = t_len - 2 * m
        out_f = self.v_net.scan_dir(self.v_net.rnn_f, x, reverse=False)
        idx = torch.arange(l_out, device=x.device)[:, None] + m \
            + torch.arange(m + 1, device=x.device)[None]
        win = x[idx]                               # (L, m+1, N, F)
        win = win.transpose(0, 1).reshape(m + 1, l_out * n, -1)
        # the backward pass over every window at once: its output at the
        # window's first frame
        out_b = self.v_net.scan_dir(self.v_net.rnn_b, win, reverse=True)[0]
        out_b = out_b.reshape(l_out, n, -1)
        out = torch.cat([out_f[m:t_len - m], out_b], -1)
        return out.transpose(0, 1)                 # (N, L, v_hdim)
