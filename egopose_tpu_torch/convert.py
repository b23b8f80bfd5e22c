"""Weights carried across to and from the JAX package.

``params_from_jax`` turns the flax parameter trees of an ego-mimic or an
ego-forecast agent (nested dicts of numpy arrays, as the JAX package
pickles them) into the port's ``state_dict``s; ``params_to_jax`` is its
inverse.  ``discriminator_from_jax`` and ``policy_discrete_from_jax`` carry
the VGAIL discriminator with its context net and the discrete policy
across.  ``video_reg_net_from_jax`` / ``video_reg_net_to_jax`` do the
same for the state-regression net, BatchNorm statistics included.
``load_checkpoint_pickle`` reads the committed
``results/egomimic/<cfg>/models/iter_*.p`` without importing the JAX
package: the one class those pickles reference,
``egopose_tpu.ops.running_norm.RunningStat``, resolves to the port's own.
``save_checkpoint_pickle`` writes the same layout, naming that class, so
either package loads what the port saves.
"""
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


_JAX_RUNNING_STAT = ("egopose_tpu.ops.running_norm", "RunningStat")


class _JaxRunningStatRef:
    """Stands for the JAX package's RunningStat class in a pickle."""


class _CheckpointPickler(pickle._Pickler):
    """Pickles the port's RunningStat as the JAX package's (by name, without
    importing it), so the checkpoint has the JAX package's layout."""

    def reducer_override(self, obj):
        if isinstance(obj, RunningStat):
            return _JaxRunningStatRef, tuple(obj)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _JaxRunningStatRef:
            return super().save_global(obj, name)
        for part in _JAX_RUNNING_STAT:
            self.save(part)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_checkpoint_pickle(path: str, cp: dict):
    """Write a checkpoint dict (flax-layout trees of numpy arrays and a
    RunningStat of numpy arrays) as the JAX package's AgentEgo.save does."""
    buf = io.BytesIO()
    _CheckpointPickler(buf, protocol=4).dump(cp)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _kernel_to_torch(k):
    """flax kernel -> torch weight: Conv2d (H, W, I, O) -> (O, I, H, W),
    Conv1d (K, I, O) -> (O, I, K), Dense (I, O) -> (O, I)."""
    k = np.asarray(k)
    perm = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}[k.ndim]
    return torch.as_tensor(np.ascontiguousarray(np.transpose(k, perm)))


def _kernel_to_jax(w):
    """The inverse of _kernel_to_torch."""
    w = _np(w)
    perm = {4: (2, 3, 1, 0), 3: (2, 1, 0), 2: (1, 0)}[w.ndim]
    return np.ascontiguousarray(np.transpose(w, perm))


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
_WN_INDEX = {"conv1": 0, "conv2": 1}


def state_dict_to_tree(sd: dict):
    """The inverse of tree_to_state_dict: a state_dict -> (params,
    batch_stats) flax trees of numpy arrays."""
    params, stats = {}, {}
    modules = {}
    for key, val in sd.items():
        path, _, leaf = key.rpartition(".")
        modules.setdefault(path, {})[leaf] = val

    def node(tree, parts):
        for part in parts:
            tree = tree.setdefault(part, {})
        return tree

    for path, leaves in modules.items():
        parts = path.split(".") if path else []
        merged = []
        for part in parts:          # layers.i -> Dense_i
            if merged and merged[-1] == "layers" and part.isdigit():
                merged[-1] = f"Dense_{part}"
            else:
                merged.append(part)
        if "running_mean" in leaves:
            node(params, merged).update(scale=_np(leaves["weight"]),
                                        bias=_np(leaves["bias"]))
            node(stats, merged).update(mean=_np(leaves["running_mean"]),
                                       var=_np(leaves["running_var"]))
            continue
        if "weight_v" in leaves:
            conv = merged[-1]
            node(params, merged[:-1])[f"WeightNorm_{_WN_INDEX[conv]}"] = {
                f"{conv}/kernel/scale": _np(leaves["weight_g"]).reshape(-1)}
            mod = node(params, merged)
            mod["kernel"] = _kernel_to_jax(leaves["weight_v"])
        elif "weight" in leaves:
            mod = node(params, merged)
            mod["kernel"] = _kernel_to_jax(leaves["weight"])
        else:                       # bare parameters (action_log_std)
            node(params, merged).update({k: _np(v)
                                         for k, v in leaves.items()})
            continue
        if "bias" in leaves:
            mod["bias"] = _np(leaves["bias"])
    return params, stats


def video_reg_net_from_jax(variables: dict) -> dict:
    """A VideoRegNet's flax variables ({params, batch_stats}) -> the port's
    state_dict: conv kernels HWIO -> OIHW and KIO -> OIK, WeightNorm scales
    -> weight_g, BatchNorm scale/bias/mean/var -> weight/bias/
    running_mean/running_var."""
    return tree_to_state_dict(variables["params"],
                              variables.get("batch_stats"))


def video_reg_net_to_jax(sd: dict) -> dict:
    """A VideoRegNet's state_dict -> flax variables of numpy arrays (the
    inverse of video_reg_net_from_jax; ``batch_stats`` only where the net
    has BatchNorm layers)."""
    params, stats = state_dict_to_tree(sd)
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def context_from_jax(tree) -> dict:
    """A net's flax tree (the policy, the value, or a context net:
    VideoStateNet or VideoForecastNet, LSTM or TCN) -> its state_dict."""
    return tree_to_state_dict(_params(tree))


def context_to_jax(sd: dict) -> dict:
    """A net's state_dict -> its flax variable tree."""
    return {"params": state_dict_to_tree(sd)[0]}


def params_from_jax(policy, policy_vs, value, value_vs):
    """flax trees of (PolicyGaussian, context net, Value, context net) ->
    the port's state_dicts in the same order; a context net is a
    VideoStateNet or a VideoForecastNet."""
    return tuple(map(context_from_jax, (policy, policy_vs, value, value_vs)))


def discriminator_from_jax(discrim, discrim_vs):
    """flax trees of the VGAIL Discriminator and its context net
    (VideoStateNet) -> the port's state_dicts, in the same order."""
    return context_from_jax(discrim), context_from_jax(discrim_vs)


def policy_discrete_from_jax(tree) -> dict:
    """A PolicyDiscrete's flax tree -> its state_dict."""
    return context_from_jax(tree)


def _np(t):
    return t.detach().cpu().numpy()


def params_to_jax(policy, policy_vs, value, value_vs):
    """The port's state_dicts of (PolicyGaussian, context net, Value,
    context net) -> flax variable trees of numpy arrays in the same order
    (the inverse of params_from_jax)."""
    return tuple(map(context_to_jax, (policy, policy_vs, value, value_vs)))
