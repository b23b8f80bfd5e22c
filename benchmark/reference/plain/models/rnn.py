"""LSTM (counterpart of egopose_tpu/models/rnn.py, LSTM path): a
torch.nn.LSTMCell-compatible cell with gates ordered (i, f, g, o), run over
time in batch mode, optionally bidirectional, or one step at a time with
an explicit carry (step mode)."""
from __future__ import annotations

import torch
from torch import nn


class LSTMCell(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.ih = nn.Linear(input_dim, 4 * hidden_dim)
        self.hh = nn.Linear(hidden_dim, 4 * hidden_dim)

    def forward(self, carry, x):
        h, c = carry
        i, f, g, o = torch.chunk(self.ih(x) + self.hh(h), 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h


class RNN(nn.Module):
    """Sequence LSTM over (T, B, D) -> (T, B, out_dim)."""

    def __init__(self, input_dim: int, out_dim: int, bi_dir: bool = False):
        super().__init__()
        self.bi_dir = bi_dir
        self.hidden_dim = out_dim // 2 if bi_dir else out_dim
        self.rnn_f = LSTMCell(input_dim, self.hidden_dim)
        if bi_dir:
            self.rnn_b = LSTMCell(input_dim, self.hidden_dim)

    def init_carry(self, batch_shape, like: torch.Tensor):
        h = like.new_zeros(tuple(batch_shape) + (self.hidden_dim,))
        return (h, h)

    def scan_dir(self, cell: LSTMCell, x: torch.Tensor, reverse: bool):
        carry = self.init_carry(x.shape[1:-1], x)
        steps = range(x.shape[0] - 1, -1, -1) if reverse \
            else range(x.shape[0])
        out = [None] * x.shape[0]
        for t in steps:
            carry, out[t] = cell(carry, x[t])
        return torch.stack(out, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_f = self.scan_dir(self.rnn_f, x, reverse=False)
        if not self.bi_dir:
            return out_f
        return torch.cat([out_f, self.scan_dir(self.rnn_b, x, reverse=True)],
                         -1)

    def step(self, carry, x: torch.Tensor):
        """One forward-cell step: (carry, (B, D)) -> (carry, (B, out))."""
        return self.rnn_f(carry, x)
