"""GAE advantage estimation (counterpart of egopose_tpu/ops/gae.py): a
reverse loop over time-major (T, ...) tensors, masked at episode
boundaries."""
from __future__ import annotations

import torch


def estimate_advantages(rewards, masks, values, gamma, tau, valid=None,
                        group=None):
    """GAE over time-major tensors (T, ...): returns (advantages, returns).

    masks[t] = 0 ends the episode at t (no bootstrap across it).  The
    advantages are normalized by their sample std (ddof=1, floored at
    var 1e-12); with ``valid`` the mean and std are taken over real
    transitions only (at least two counted), and with ``group``
    (parallel/mesh.Group) over every rank's: count and sum first, then the
    squared deviations about that mean."""
    advantages = torch.empty_like(values)
    prev_value = torch.zeros_like(values[0])
    prev_adv = torch.zeros_like(values[0])
    for t in range(values.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * prev_value * masks[t] - values[t]
        prev_adv = delta + gamma * tau * prev_adv * masks[t]
        advantages[t] = prev_adv
        prev_value = values[t]
    returns = values + advantages
    if valid is None:
        n = advantages.numel()
        mean = advantages.mean()
        var = torch.sum((advantages - mean) ** 2)
    else:
        cnt_sum = torch.stack([valid.sum(), torch.sum(advantages * valid)])
        if group is not None:
            cnt_sum = group.sum(cnt_sum)
        n = torch.clamp(cnt_sum[0], min=2.0)
        mean = cnt_sum[1] / n
        var = torch.sum(valid * (advantages - mean) ** 2)
        if group is not None:
            var = group.sum(var)
    std = torch.sqrt(torch.clamp(var / (n - 1), min=1e-12))
    return (advantages - mean) / std, returns
