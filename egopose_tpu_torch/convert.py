"""Weights carried across to and from the JAX package.

``params_from_jax`` turns the flax parameter trees of an ego-mimic or an
ego-forecast agent (nested dicts of numpy arrays, as the JAX package
pickles them) into the port's ``state_dict``s; ``params_to_jax`` is its
inverse.
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


def _linear(sd, prefix, dense):
    """flax Dense {kernel (in,out), bias} -> torch Linear (out,in)."""
    sd[prefix + ".weight"] = torch.as_tensor(
        np.ascontiguousarray(np.asarray(dense["kernel"]).T))
    sd[prefix + ".bias"] = torch.as_tensor(np.asarray(dense["bias"]))


def _mlp(sd, prefix, net):
    n = len([k for k in net if k.startswith("Dense_")])
    for i in range(n):
        _linear(sd, f"{prefix}.layers.{i}", net[f"Dense_{i}"])


# the LSTMs of a context net: v_net (both workloads), s_net (forecast's
# state LSTM); each with a forward cell rnn_f and, bidirectional, rnn_b
_RNNS, _CELLS = ("v_net", "s_net"), ("rnn_f", "rnn_b")


def context_from_jax(tree) -> dict:
    """A context net's flax tree (VideoStateNet or VideoForecastNet) ->
    its state_dict."""
    sd = {}
    params = _params(tree)
    for rnn in _RNNS:
        for cell in _CELLS:
            if cell in params.get(rnn, {}):
                for gate in ("ih", "hh"):
                    _linear(sd, f"{rnn}.{cell}.{gate}",
                            params[rnn][cell][gate])
    return sd


def params_from_jax(policy, policy_vs, value, value_vs):
    """flax trees of (PolicyGaussian, context net, Value, context net) ->
    the port's state_dicts in the same order; a context net is a
    VideoStateNet or a VideoForecastNet."""
    p = _params(policy)
    sd_p = {}
    _mlp(sd_p, "net", p["net"])
    _linear(sd_p, "action_mean", p["action_mean"])
    sd_p["action_log_std"] = torch.as_tensor(np.asarray(p["action_log_std"]))
    v = _params(value)
    sd_v = {}
    _mlp(sd_v, "net", v["net"])
    _linear(sd_v, "value_head", v["value_head"])
    return sd_p, context_from_jax(policy_vs), sd_v, context_from_jax(value_vs)


def _np(t):
    return t.detach().cpu().numpy()


def _dense(sd, prefix):
    """torch Linear (out,in) -> flax Dense {kernel (in,out), bias}."""
    return {"kernel": np.ascontiguousarray(_np(sd[prefix + ".weight"]).T),
            "bias": _np(sd[prefix + ".bias"])}


def _mlp_tree(sd, prefix):
    n = len([k for k in sd if k.startswith(prefix + ".layers.")
             and k.endswith(".weight")])
    return {f"Dense_{i}": _dense(sd, f"{prefix}.layers.{i}")
            for i in range(n)}


def context_to_jax(sd: dict) -> dict:
    """A context net's state_dict -> its flax variable tree."""
    tree = {}
    for rnn in _RNNS:
        cells = {cell: {gate: _dense(sd, f"{rnn}.{cell}.{gate}")
                        for gate in ("ih", "hh")}
                 for cell in _CELLS if f"{rnn}.{cell}.ih.weight" in sd}
        if cells:
            tree[rnn] = cells
    return {"params": tree}


def params_to_jax(policy, policy_vs, value, value_vs):
    """The port's state_dicts of (PolicyGaussian, context net, Value,
    context net) -> flax variable trees of numpy arrays in the same order
    (the inverse of params_from_jax)."""
    pol = {"net": _mlp_tree(policy, "net"),
           "action_mean": _dense(policy, "action_mean"),
           "action_log_std": _np(policy["action_log_std"])}
    val = {"net": _mlp_tree(value, "net"),
           "value_head": _dense(value, "value_head")}
    return ({"params": pol}, context_to_jax(policy_vs), {"params": val},
            context_to_jax(value_vs))
