"""LSTM (counterpart of egopose_tpu/models/rnn.py, LSTM path): a
torch.nn.LSTMCell-compatible cell with gates ordered (i, f, g, o), run over
time in batch mode, optionally bidirectional, or one step at a time with
an explicit carry (step mode).

Batch mode dispatches on the input's device: a CUDA tensor takes K6
(ops/lstm.py), both directions in one launch after one input-projection
matmul, under autograd and torch.func's grad, vjp and jvp alike (TRPO's
Fisher products); a CPU tensor runs the loop of cells (``loop``).  K6 has
no forward over reverse: a jvp of a grad through a CUDA tensor raises.
Step mode is the cell."""
from __future__ import annotations

import torch
from torch import nn

from ..ops import lstm


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

    def loop(self, cell: LSTMCell, x: torch.Tensor, reverse: bool):
        """One direction over (T, ..., D) as a loop of cells."""
        carry = self.init_carry(x.shape[1:-1], x)
        steps = range(x.shape[0] - 1, -1, -1) if reverse \
            else range(x.shape[0])
        out = [None] * x.shape[0]
        for t in steps:
            carry, out[t] = cell(carry, x[t])
        return torch.stack(out, 0)

    def recurrence(self, x: torch.Tensor, cells, reverse) -> torch.Tensor:
        """``cells`` over (T, ..., D), their outputs side by side: the input
        projections as one matmul, then lstm.recurrence."""
        t, b = x.shape[0], x.shape[1:-1].numel()
        w_ih = torch.cat([c.ih.weight for c in cells])
        bias = torch.cat([c.ih.bias + c.hh.bias for c in cells])
        xg = torch.addmm(bias, x.reshape(t * b, x.shape[-1]), w_ih.t())
        wt = torch.stack([c.hh.weight.t() for c in cells])
        out = lstm.recurrence(xg.view(t, b, w_ih.shape[0]), wt, reverse)
        return out.view(x.shape[:-1] + (len(cells) * self.hidden_dim,))

    def scan_dir(self, cell: LSTMCell, x: torch.Tensor, reverse: bool):
        if x.is_cuda:
            return self.recurrence(x, (cell,), (reverse,))
        return self.loop(cell, x, reverse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            cells = (self.rnn_f, self.rnn_b) if self.bi_dir else (self.rnn_f,)
            return self.recurrence(x, cells, (False, True)[:len(cells)])
        out_f = self.loop(self.rnn_f, x, reverse=False)
        if not self.bi_dir:
            return out_f
        return torch.cat([out_f, self.loop(self.rnn_b, x, reverse=True)], -1)

    def step(self, carry, x: torch.Tensor):
        """One forward-cell step: (carry, (B, D)) -> (carry, (B, out))."""
        return self.rnn_f(carry, x)
