"""Nets of egopose_tpu_torch with weights carried across by
convert.params_from_jax against the flax modules, float64 on the CPU, to
1e-10: the policy mean, the value, the bi-LSTM VideoStateNet window and
causal_encode, and RunningStat normalization."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu.models.video_state_net import VideoStateNet as JVideoStateNet
from egopose_tpu.ops import running_norm as jrn
from egopose_tpu.rl.nets import PolicyGaussian as JPolicy, Value as JValue
from egopose_tpu_torch.convert import load_checkpoint_pickle, params_from_jax
from egopose_tpu_torch.models.video_state_net import VideoStateNet
from egopose_tpu_torch.ops import running_norm as trn
from egopose_tpu_torch.rl.nets import PolicyGaussian, Value

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results", "egomimic", "subject_03", "models",
                    "iter_0800.p")
TOL = 1e-10


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module", params=["checkpoint", "fresh"])
def trees(request):
    """flax parameter trees: the committed checkpoint's, or a fresh flax
    init at other widths (so the mapping is not tied to one shape)."""
    if request.param == "checkpoint":
        cp = load_checkpoint_pickle(CKPT)
        return dict(obs=115, act=52, feat=64, vh=128, hidden=(300, 200),
                    trees=[_f64(cp[k]) for k in ("policy_dict",
                                                 "policy_vs_dict",
                                                 "value_dict",
                                                 "value_vs_dict")])
    dims = dict(obs=9, act=5, feat=6, vh=8, hidden=(16, 12))
    k = jax.random.split(jax.random.PRNGKey(3), 4)
    vs = JVideoStateNet(dims["feat"], dims["vh"], 4, "lstm")
    x_win = jnp.zeros((1, 12, dims["feat"]))
    dims["trees"] = [
        JPolicy(dims["act"], dims["hidden"], "relu", -1.0).init(
            k[0], jnp.zeros((1, dims["obs"] + dims["vh"]))),
        vs.init(k[1], x_win),
        JValue(dims["hidden"], "relu").init(
            k[2], jnp.zeros((1, dims["obs"] + dims["vh"]))),
        vs.init(k[3], x_win)]
    dims["trees"] = [_f64(t) for t in dims["trees"]]
    return dims


def _load(module, sd):
    module.load_state_dict({k: v.double() for k, v in sd.items()})
    return module.double().eval()


def test_policy_and_value_match_flax(trees):
    sd_p, _, sd_v, _ = params_from_jax(*trees["trees"])
    x = np.random.RandomState(0).randn(7, trees["obs"] + trees["vh"])
    jp = JPolicy(trees["act"], trees["hidden"], "relu", -2.3)
    mean_j, log_std_j = jp.apply(trees["trees"][0], jnp.asarray(x))
    tp = _load(PolicyGaussian(x.shape[1], trees["act"], trees["hidden"]),
               sd_p)
    mean_t, log_std_t = tp(torch.tensor(x))
    np.testing.assert_allclose(mean_t.detach().numpy(), np.asarray(mean_j),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(log_std_t.detach().numpy(),
                               np.asarray(log_std_j), rtol=0, atol=TOL)
    val_j = JValue(trees["hidden"], "relu").apply(trees["trees"][2],
                                                  jnp.asarray(x))
    tv = _load(Value(x.shape[1], trees["hidden"]), sd_v)
    np.testing.assert_allclose(tv(torch.tensor(x)).detach().numpy(),
                               np.asarray(val_j), rtol=0, atol=TOL)


@pytest.mark.parametrize("method", ["window", "causal_encode"])
def test_video_state_net_matches_flax(trees, method):
    _, sd_vs, _, _ = params_from_jax(*trees["trees"])
    margin = 4
    feats = np.random.RandomState(1).randn(3, 20, trees["feat"])
    jv = JVideoStateNet(trees["feat"], trees["vh"], margin, "lstm")
    tv = _load(VideoStateNet(trees["feat"], trees["vh"], margin), sd_vs)
    if method == "window":
        want = jv.apply(trees["trees"][1], jnp.asarray(feats))
        got = tv(torch.tensor(feats))
    else:
        want = jv.apply(trees["trees"][1], jnp.asarray(feats),
                        method=jv.causal_encode)
        got = tv.causal_encode(torch.tensor(feats))
    assert got.shape == (3, 20 - 2 * margin, trees["vh"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


def test_running_stat_apply_matches_jax():
    rng = np.random.RandomState(2)
    stat = (np.float64(37.0), rng.randn(11), rng.rand(11) * 50)
    x = rng.randn(6, 11) * 3
    got = trn.apply(trn.to_tensors(trn.RunningStat(*stat), "cpu"),
                    torch.tensor(x), clip=5.0)
    want = jrn.apply(jrn.RunningStat(*map(jnp.asarray, stat)),
                     jnp.asarray(x), clip=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    assert (got.abs() <= 5.0).all() and (got.abs() == 5.0).any()
