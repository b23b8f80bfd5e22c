"""Checkpoint loading (frozen copy of the loading half of
egopose_tpu_torch/convert.py): the committed pickles' flax trees into
state_dicts, and the unpickler that maps the one class they name.
Only load checkpoints this project wrote: unpickling runs code."""
from __future__ import annotations

import importlib
import io
import pickle

import numpy as np
import torch

from .ops.running_norm import RunningStat

_CLASS_MAP = {("egopose_tpu.ops.running_norm", "RunningStat"): RunningStat}


class _CheckpointUnpickler(pickle.Unpickler):
    """Maps the JAX package's RunningStat to the port's; refuses any other
    class of the JAX package.  Pickles written by numpy >= 2 name
    ``numpy._core``; older numpy reads them through ``numpy.core``."""

    def find_class(self, module, name):
        if (module, name) in _CLASS_MAP:
            return _CLASS_MAP[(module, name)]
        if module.split(".")[0] == "egopose_tpu":
            raise pickle.UnpicklingError(
                f"checkpoint references {module}.{name}, which the port "
                "does not map")
        if module.startswith("numpy._core"):
            try:
                importlib.import_module(module)
            except ImportError:
                module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_checkpoint_pickle(path: str) -> dict:
    """Load an agent's checkpoint pickle (our format: flax trees + a
    RunningStat) with numpy leaves, importing nothing of the JAX package.
    Only load checkpoints this project wrote: unpickling runs code."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _kernel_to_torch(k):
    """flax kernel -> torch weight: Conv2d (H, W, I, O) -> (O, I, H, W),
    Conv1d (K, I, O) -> (O, I, K), Dense (I, O) -> (O, I)."""
    k = np.asarray(k)
    perm = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}[k.ndim]
    return torch.as_tensor(np.ascontiguousarray(np.transpose(k, perm)))


def _torch_part(name):
    """A flax module name -> the port's attribute path: an MLP's
    ``Dense_i`` is its ``layers.i``; every other name is the same."""
    return "layers." + name[len("Dense_"):] if name.startswith("Dense_") \
        else name


def tree_to_state_dict(params: dict, stats: dict | None = None,
                       prefix: str = "") -> dict:
    """A flax parameter tree (with its ``batch_stats`` tree) of one of the
    port's modules -> its state_dict.  Leaves map by kind: a Dense or Conv
    ``kernel`` -> ``weight`` (transposed to torch's layout), a kernel under
    a ``WeightNorm_j`` -> ``weight_v`` with the scale as ``weight_g`` (out,
    1, 1), a BatchNorm ``scale``/``bias`` + stats ``mean``/``var`` ->
    ``weight``/``bias``/``running_mean``/``running_var``."""
    stats = stats or {}
    sd = {}
    scales = {name.split("/")[0]: np.asarray(s)
              for key, wn in params.items() if key.startswith("WeightNorm_")
              for name, s in wn.items()}
    for key, val in params.items():
        if key.startswith("WeightNorm_"):
            continue
        name = prefix + _torch_part(key)
        if not isinstance(val, dict):
            sd[name] = torch.as_tensor(np.asarray(val))
        elif "kernel" in val:
            w = _kernel_to_torch(val["kernel"])
            if key in scales:
                sd[name + ".weight_v"] = w
                sd[name + ".weight_g"] = torch.as_tensor(
                    scales[key].reshape(-1, 1, 1))
            else:
                sd[name + ".weight"] = w
            if "bias" in val:
                sd[name + ".bias"] = torch.as_tensor(np.asarray(val["bias"]))
        elif "scale" in val:
            sd[name + ".weight"] = torch.as_tensor(np.asarray(val["scale"]))
            sd[name + ".bias"] = torch.as_tensor(np.asarray(val["bias"]))
            sd[name + ".running_mean"] = torch.as_tensor(
                np.asarray(stats[key]["mean"]))
            sd[name + ".running_var"] = torch.as_tensor(
                np.asarray(stats[key]["var"]))
        else:
            sd.update(tree_to_state_dict(val, stats.get(key), name + "."))
    return sd


# a TemporalBlock's convs in flax's creation order: conv1's WeightNorm is
# WeightNorm_0, conv2's WeightNorm_1


def context_from_jax(tree) -> dict:
    """A net's flax tree (the policy, the value, or a context net:
    VideoStateNet or VideoForecastNet, LSTM or TCN) -> its state_dict."""
    return tree_to_state_dict(_params(tree))


def params_from_jax(policy, policy_vs, value, value_vs):
    """flax trees of (PolicyGaussian, context net, Value, context net) ->
    the port's state_dicts in the same order; a context net is a
    VideoStateNet or a VideoForecastNet."""
    return tuple(map(context_from_jax, (policy, policy_vs, value, value_vs)))
