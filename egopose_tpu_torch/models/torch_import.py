"""Reference-format checkpoints (the original PyTorch EgoPose code's
pickled ``state_dict``s) -> the port's modules (counterpart of
egopose_tpu/models/torch_import.py).

Both sides are PyTorch, so the import is the identity up to key renames,
each written out below:

- MLP ``affine_layers.N`` -> ``layers.N``
- ``nn.LSTMCell`` ``weight_ih``/``bias_ih``/``weight_hh``/``bias_hh`` ->
  the port's cell's ``ih``/``hh`` Linear pair (same gate order i, f, g, o)
- TCN ``network.i.conv{1,2}.weight_{g,v}``/``bias`` -> ``block{i}.conv{1,2}``
  (the same weight_norm parametrisation), ``network.i.downsample`` ->
  ``block{i}.downsample``; the ``network.i.net.*`` aliases are dropped
- torchvision ResNet-18 under ``resnet.``: ``layer{l}.{b}.`` ->
  ``layer{l}_{b}.``, ``downsample.0``/``.1`` -> ``down_conv``/``down_bn``
- MobileNet ``model.0.{0,1}`` -> ``c0_conv``/``c0_bn``, ``model.{i+1}.
  {0,1,3,4}`` -> ``dw{i}_dw``/``_dwbn``/``_pw``/``_pwbn``
- BatchNorm's ``num_batches_tracked`` is dropped
- ``action_log_std`` (1, A) -> (A,)
- a pickled ``ZFilter`` -> ``RunningStat`` of numpy arrays.

Every function returns the port's ``state_dict``s with the checkpoint's
own dtype (the reference saves float64); callers cast on load.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from ..convert import _CheckpointUnpickler, video_reg_net_from_jax
from ..ops.running_norm import RunningStat


class _Stub:
    """Attribute bag standing in for a class of the reference code base
    that cannot be imported here (``utils.zfilter.ZFilter``, the config
    classes): pickle restores the instance's ``__dict__`` into it."""

    def __init__(self, *a, **k):
        pass


class _TolerantUnpickler(_CheckpointUnpickler):
    """The port's checkpoint unpickler (the JAX package's RunningStat maps
    to the port's) that stubs every class it cannot import instead of
    failing, and never imports the JAX package."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError, pickle.UnpicklingError):
            return type(name, (_Stub,), {"__module__": module})


def tolerant_pickle_load(path: str):
    """Load a checkpoint pickle of either package or of the reference code
    base.  Only load checkpoints you trust: unpickling runs code."""
    with open(path, "rb") as f:
        return _TolerantUnpickler(f).load()


def looks_torch_state_dict(d) -> bool:
    """True for a flat torch-style state_dict (dotted keys or tensor
    values), False for a flax variables dict ({'params': ...})."""
    if not isinstance(d, dict) or not d:
        return False
    if "params" in d or "batch_stats" in d:
        return False
    return any("." in k for k in d) or \
        any(isinstance(v, torch.Tensor) for v in d.values())


def _t(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) \
        else torch.as_tensor(np.asarray(v))


def _take(sd, src, out, dst, leaves):
    """Copy ``src.<leaf>`` to ``dst.<leaf>`` for every leaf present."""
    for leaf in leaves:
        if f"{src}.{leaf}" in sd:
            out[f"{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])


def import_mlp(sd, src: str, dst: str) -> dict:
    """Reference MLP (``<src>affine_layers.N``) -> the port's MLP
    (``<dst>layers.N``)."""
    out, i = {}, 0
    while f"{src}affine_layers.{i}.weight" in sd:
        _take(sd, f"{src}affine_layers.{i}", out, f"{dst}layers.{i}",
              ("weight", "bias"))
        i += 1
    return out


def import_lstm_cell(sd, src: str, dst: str) -> dict:
    """``nn.LSTMCell`` -> the port's LSTMCell (``ih``/``hh`` Linears)."""
    out = {}
    for gate in ("ih", "hh"):
        out[f"{dst}.{gate}.weight"] = _t(sd[f"{src}.weight_{gate}"])
        out[f"{dst}.{gate}.bias"] = _t(sd[f"{src}.bias_{gate}"])
    return out


def import_rnn(sd, src: str, dst: str, bi_dir: bool) -> dict:
    """Reference RNN (``rnn_f``/``rnn_b`` LSTMCells) -> the port's RNN."""
    out = import_lstm_cell(sd, f"{src}rnn_f", f"{dst}rnn_f")
    if bi_dir:
        out.update(import_lstm_cell(sd, f"{src}rnn_b", f"{dst}rnn_b"))
    return out


def import_tcn(sd, src: str, dst: str) -> dict:
    """Reference weight-norm TemporalConvNet (``<src>network.i``) -> the
    port's (``<dst>block{i}``)."""
    out, i = {}, 0
    while f"{src}network.{i}.conv1.weight_v" in sd:
        for conv in ("conv1", "conv2"):
            _take(sd, f"{src}network.{i}.{conv}", out,
                  f"{dst}block{i}.{conv}", ("weight_g", "weight_v", "bias"))
        _take(sd, f"{src}network.{i}.downsample", out,
              f"{dst}block{i}.downsample", ("weight", "bias"))
        i += 1
    if i == 0:
        raise KeyError(f"no TCN blocks under '{src}network.'")
    return out


def import_v_net(sd, src: str, dst: str, v_net_type: str,
                 bi_dir: bool) -> dict:
    """A video model's temporal net: LSTM or weight-norm TCN."""
    if v_net_type == "tcn":
        return import_tcn(sd, src, dst)
    return import_rnn(sd, src, dst, bi_dir)


def import_policy_gaussian(sd) -> dict:
    """core/policy_gaussian.py -> the port's PolicyGaussian."""
    out = import_mlp(sd, "net.", "net.")
    _take(sd, "action_mean", out, "action_mean", ("weight", "bias"))
    out["action_log_std"] = _t(sd["action_log_std"]).reshape(-1)
    return out


def import_value(sd) -> dict:
    """core/critic.py -> the port's Value."""
    out = import_mlp(sd, "net.", "net.")
    _take(sd, "value_head", out, "value_head", ("weight", "bias"))
    return out


def import_video_state_net(sd, bi_dir: bool = True,
                           v_net_type: str = "lstm") -> dict:
    """models/video_state_net.py -> the port's VideoStateNet."""
    return import_v_net(sd, "v_net.", "v_net.", v_net_type, bi_dir)


def import_video_forecast_net(sd, v_net_type: str = "lstm") -> dict:
    """models/video_forecast_net.py -> the port's VideoForecastNet (a
    causal v_net and, where the checkpoint has one, the state LSTM)."""
    out = import_v_net(sd, "v_net.", "v_net.", v_net_type, bi_dir=False)
    if any(k.startswith("s_net.") for k in sd):
        out.update(import_rnn(sd, "s_net.", "s_net.", bi_dir=False))
    return out


def import_running_state(running_state) -> RunningStat:
    """A pickled ZFilter (utils/zfilter.py: ``rs._n``, ``rs._M``,
    ``rs._S``) -> RunningStat of numpy arrays."""
    rs = getattr(running_state, "rs", running_state)
    return RunningStat(n=np.asarray(float(rs._n)), mean=np.asarray(rs._M),
                       s=np.asarray(rs._S))


def import_mimic_checkpoint(cp: dict, bi_dir: bool = True,
                            v_net_type: str = "lstm",
                            value_v_net_type: str | None = None) -> dict:
    """A reference ego-mimic checkpoint (ego_mimic.py:133-139) -> the
    port's state_dicts under the same keys, and the RunningStat."""
    return {
        "policy_dict": import_policy_gaussian(cp["policy_dict"]),
        "policy_vs_dict": import_video_state_net(cp["policy_vs_dict"],
                                                 bi_dir, v_net_type),
        "value_dict": import_value(cp["value_dict"]),
        "value_vs_dict": import_video_state_net(
            cp["value_vs_dict"], bi_dir, value_v_net_type or v_net_type),
        "running_state": import_running_state(cp["running_state"])}


def import_forecast_checkpoint(cp: dict, policy_v_net: str = "lstm",
                               value_v_net: str = "lstm") -> dict:
    """A reference ego-forecast checkpoint (VideoForecastNet context nets,
    ego_forecast.py:140-147) -> the port's state_dicts."""
    return {
        "policy_dict": import_policy_gaussian(cp["policy_dict"]),
        "policy_vs_dict": import_video_forecast_net(cp["policy_vs_dict"],
                                                    policy_v_net),
        "value_dict": import_value(cp["value_dict"]),
        "value_vs_dict": import_video_forecast_net(cp["value_vs_dict"],
                                                   value_v_net),
        "running_state": import_running_state(cp["running_state"])}


_BN = ("weight", "bias", "running_mean", "running_var")


def import_resnet18(sd, src: str = "resnet.", dst: str = "") -> dict:
    """torchvision resnet18 under the reference's wrapper (fc replaced) ->
    the port's ResNet18."""
    out = {}
    _take(sd, f"{src}conv1", out, f"{dst}conv1", ("weight",))
    _take(sd, f"{src}bn1", out, f"{dst}bn1", _BN)
    for li in range(1, 5):
        for b in range(2):
            s, d = f"{src}layer{li}.{b}", f"{dst}layer{li}_{b}"
            for conv in ("conv1", "conv2"):
                _take(sd, f"{s}.{conv}", out, f"{d}.{conv}", ("weight",))
            for bn in ("bn1", "bn2"):
                _take(sd, f"{s}.{bn}", out, f"{d}.{bn}", _BN)
            _take(sd, f"{s}.downsample.0", out, f"{d}.down_conv",
                  ("weight",))
            _take(sd, f"{s}.downsample.1", out, f"{d}.down_bn", _BN)
    _take(sd, f"{src}fc", out, f"{dst}fc", ("weight", "bias"))
    return out


def import_mobile_net(sd, src: str = "", dst: str = "") -> dict:
    """models/mobile_net.py (Sequential conv_bn + 13 conv_dw, fc) -> the
    port's MobileNet."""
    out = {}
    _take(sd, f"{src}model.0.0", out, f"{dst}c0_conv", ("weight",))
    _take(sd, f"{src}model.0.1", out, f"{dst}c0_bn", _BN)
    for i in range(13):
        s, d = f"{src}model.{i + 1}", f"{dst}dw{i}"
        _take(sd, f"{s}.0", out, f"{d}_dw", ("weight",))
        _take(sd, f"{s}.1", out, f"{d}_dwbn", _BN)
        _take(sd, f"{s}.3", out, f"{d}_pw", ("weight",))
        _take(sd, f"{s}.4", out, f"{d}_pwbn", _BN)
    _take(sd, f"{src}fc", out, f"{dst}fc", ("weight", "bias"))
    return out


def import_video_reg_net(sd, cnn_type: str = "resnet",
                         v_net_type: str = "lstm",
                         causal: bool = False) -> dict:
    """models/video_reg_net.py -> the port's VideoRegNet, a full net (with
    its CNN) or a no_cnn inference net (state_reg.py save_inf)."""
    out = {}
    if any(k.startswith("cnn.") for k in sd):
        out.update(import_resnet18(sd, "cnn.resnet.", "cnn.")
                   if cnn_type == "resnet"
                   else import_mobile_net(sd, "cnn.", "cnn."))
    out.update(import_v_net(sd, "v_net.", "v_net.", v_net_type,
                            bi_dir=not causal))
    out.update(import_mlp(sd, "mlp.", "mlp."))
    _take(sd, "linear", out, "linear", ("weight", "bias"))
    return out


def strip_cnn(sd: dict) -> dict:
    """A VideoRegNet state_dict without its CNN (the reference's no_cnn
    strict=False load)."""
    return {k: v for k, v in sd.items() if not k.startswith("cnn.")}


def maybe_import_statereg(model_cp: dict, meta: dict,
                          cnn_type: str = "resnet", v_net_type: str = "lstm",
                          causal: bool = False, no_cnn: bool = False):
    """A statereg checkpoint of either package (flax variables) or of the
    reference (a torch state_dict; state_reg.py:91-95, save_inf :180-184)
    -> (the port's VideoRegNet state_dict, mean, std).  With ``no_cnn`` the
    CNN is dropped, so a full or an ``_inf`` checkpoint fits a no_cnn
    net."""
    sd = model_cp["state_net_dict"]
    sd = import_video_reg_net(sd, cnn_type, v_net_type, causal) \
        if looks_torch_state_dict(sd) else video_reg_net_from_jax(sd)
    if no_cnn:
        sd = strip_cnn(sd)
    return sd, np.asarray(meta["mean"]), np.asarray(meta["std"])
