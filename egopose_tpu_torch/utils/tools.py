"""Result-dict helpers (counterpart of egopose_tpu/utils/tools.py)."""
from __future__ import annotations


def remove_noisy_hands(results):
    """Zero the hand dims of every trajectory in place; read-only arrays
    are replaced by writable copies."""
    for traj in results.values():
        for take in traj.keys():
            arr = traj[take]
            if not arr.flags.writeable:
                arr = arr.copy()
                traj[take] = arr
            arr[..., 32:35] = 0
            arr[..., 42:45] = 0
