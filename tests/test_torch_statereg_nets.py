"""The state-regression nets of egopose_tpu_torch against the JAX
package's flax modules, float64 on the CPU, weights carried across by
convert.py: the TCN (causal and not, alone and as the context net of
VideoStateNet / VideoForecastNet), ResNet-18, MobileNet and VideoRegNet
(resnet / mobile x LSTM / TCN, no_cnn, cnn_feature) in eval mode and in
training mode (output and the updated BatchNorm statistics, the biased
variance of flax), forward at 1e-10 relative to the output's scale; one
training step (loss, gradients, Adam update, BatchNorm statistics)
against the same step written with the JAX package's VideoRegNet and
optax, at 1e-8."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from egopose_tpu.models.tcn import TemporalConvNet as JTCN
from egopose_tpu.models.video_forecast_net import \
    VideoForecastNet as JVideoForecastNet
from egopose_tpu.models.video_reg_net import VideoRegNet as JVideoRegNet
from egopose_tpu.models.video_state_net import VideoStateNet as JVideoStateNet
from egopose_tpu_torch.cli.state_reg import train_step
from egopose_tpu_torch.convert import (context_from_jax, context_to_jax,
                                       tree_to_state_dict,
                                       video_reg_net_from_jax,
                                       video_reg_net_to_jax)
from egopose_tpu_torch.models.batch_norm import BatchNorm
from egopose_tpu_torch.models.tcn import TemporalConvNet
from egopose_tpu_torch.models.video_forecast_net import VideoForecastNet
from egopose_tpu_torch.models.video_reg_net import VideoRegNet
from egopose_tpu_torch.models.video_state_net import VideoStateNet

TOL = 1e-10          # forward, relative to the largest output magnitude
STEP_TOL = 1e-8      # one training step
RES = 32             # the synthetic flow's default resolution
TCN = {"size": [6, 8], "kernel_size": 3, "dropout": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; the small CPU tensors
    here gain nothing from intra-op threads, which oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed, scale=0.1):
    """A flax tree with every leaf moved off its init (unit WeightNorm
    scales and BatchNorm statistics would hide a dropped leaf)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + scale * rng.rand(*np.shape(a)), tree)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= tol, err


def _tree_close(got, want, tol):
    jax.tree_util.tree_map(lambda a, b: _close(a, b, tol), got, want)


@pytest.mark.parametrize("causal", [False, True])
def test_tcn_matches_flax(causal):
    jnet = JTCN([6, 8], 3, 0.0, causal)
    x = np.random.RandomState(0).randn(3, 17, 5)
    tree = _perturbed(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    net = TemporalConvNet(5, [6, 8], 3, 0.0, causal).double()
    net.load_state_dict(tree_to_state_dict(tree["params"]))
    want = jnet.apply(tree, jnp.asarray(x))
    _close(net(torch.tensor(x)).detach().numpy(), want)
    # WeightNorm scale (out,) <-> weight_g (out, 1, 1), and back
    assert net.block0.conv1.weight_g.shape == (6, 1, 1)
    back = context_to_jax(net.state_dict())["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           tree["params"])


@pytest.mark.parametrize("causal", [False, True])
def test_video_state_net_tcn_matches_flax(causal):
    m = 3
    feats = np.random.RandomState(1).randn(2, 16, 5)
    jnet = JVideoStateNet(5, 8, m, "tcn", TCN, causal)
    tree = _perturbed(jnet.init(jax.random.PRNGKey(1), jnp.asarray(feats)), 1)
    net = VideoStateNet(5, 8, m, "tcn", causal, TCN).double().eval()
    net.load_state_dict(context_from_jax(tree))
    _close(net(torch.tensor(feats)).detach().numpy(),
           jnet.apply(tree, jnp.asarray(feats)))
    if causal:
        _close(net.causal_encode(torch.tensor(feats)).detach().numpy(),
               jnet.apply(tree, jnp.asarray(feats),
                          method=jnet.causal_encode))
    else:
        with pytest.raises(NotImplementedError, match="causal: true"):
            net.causal_encode(torch.tensor(feats))


def test_video_forecast_net_tcn_matches_flax():
    windows = np.random.RandomState(2).randn(3, 7, 5)
    states = np.random.RandomState(3).randn(4, 3, 9)
    jnet = JVideoForecastNet(5, 9, 8, 7, "tcn", TCN, 6, "lstm")
    tree = _perturbed(jnet.init(jax.random.PRNGKey(2), jnp.asarray(windows),
                                method=jnet.encode_video), 2)
    tree["params"].update(_perturbed(jnet.init(
        jax.random.PRNGKey(3), jnp.asarray(states),
        method=jnet.s_batch), 3)["params"])
    net = VideoForecastNet(5, 9, 8, 7, "tcn", 6, "lstm",
                           v_net_param=TCN).double().eval()
    net.load_state_dict(context_from_jax(tree))
    _close(net.encode_video(torch.tensor(windows)).detach().numpy(),
           jnet.apply(tree, jnp.asarray(windows), method=jnet.encode_video))
    _close(net.s_batch(torch.tensor(states)).detach().numpy(),
           jnet.apply(tree, jnp.asarray(states), method=jnet.s_batch))


# ResNet-18 with the bidirectional LSTM, MobileNet with the causal TCN,
# and both temporal nets again without a CNN
CASES = {
    "resnet_lstm": dict(cnn_type="resnet", v_net_type="lstm", causal=False),
    "mobile_tcn": dict(cnn_type="mobile", v_net_type="tcn", causal=True),
    "nocnn_lstm": dict(no_cnn=True, v_net_type="lstm", causal=True),
    "nocnn_tcn": dict(no_cnn=True, v_net_type="tcn", causal=False)}
OUT, VH, FDIM = 5, 8, 6


def _kw(case):
    return dict(frame_shape=(RES, RES, 3), mlp_dim=(12, 10),
                v_net_param=TCN, **CASES[case])


@pytest.fixture(scope="module", params=sorted(CASES))
def reg(request):
    """(case, flax net, perturbed variables, port net in f64, input)."""
    case = request.param
    rng = np.random.RandomState(4)
    x = rng.randn(4, 2, FDIM) if "nocnn" in case \
        else rng.randn(4, 2, RES, RES, 3)
    jnet = JVideoRegNet(OUT, VH, FDIM, **_kw(case))
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    variables = _perturbed(jax.device_get(variables), 5)
    if "batch_stats" in variables:        # a positive running variance
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: 0.5 + np.abs(a), variables["batch_stats"])
    net = VideoRegNet(OUT, VH, FDIM, **_kw(case)).double()
    net.load_state_dict(video_reg_net_from_jax(variables))
    return case, jnet, variables, net, x


def test_video_reg_net_eval_matches_flax(reg):
    case, jnet, variables, net, x = reg
    net.eval()
    with torch.no_grad():
        _close(net(torch.tensor(x)).numpy(),
               jax.jit(jnet.apply)(variables, jnp.asarray(x)))
        if net.cnn is not None:
            frames = x.reshape((-1, RES, RES, 3))
            _close(net.cnn_feature(torch.tensor(frames)).numpy(),
                   jnet.apply(variables, jnp.asarray(frames),
                              method=jnet.cnn_feature))
    # the variables carry back unchanged
    back = video_reg_net_to_jax(net.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, variables)


def test_video_reg_net_train_mode_matches_flax(reg):
    """Training mode normalises with the batch's statistics and folds the
    biased batch variance into the running one (torch's own BatchNorm
    would fold the unbiased one).  Without a CNN (no BatchNorm, dropout 0)
    it is the eval-mode pass and there are no statistics."""
    case, jnet, variables, net, x = reg
    want, upd = jax.jit(lambda v, x: jnet.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    trained = VideoRegNet(OUT, VH, FDIM, **_kw(case)).double()
    trained.load_state_dict(net.state_dict())
    trained.train()
    with torch.no_grad():
        _close(trained(torch.tensor(x)).numpy(), want)
    back = video_reg_net_to_jax(trained.state_dict())
    assert ("batch_stats" in back) == (trained.cnn is not None) \
        == bool(upd)
    if trained.cnn is not None:
        _tree_close(back["batch_stats"], jax.device_get(upd["batch_stats"]),
                    TOL)


def test_batch_norm_running_variance_is_biased():
    bn = BatchNorm(3).double().train()
    x = torch.randn(4, 3, 2, 2, dtype=torch.float64)
    bn(x)
    var = x.transpose(0, 1).reshape(3, -1).var(1, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=0,
                               atol=1e-15)


def test_one_training_step_matches_optax():
    """The port's train_step (torch.optim.Adam) against the JAX CLI's step
    written out here with the JAX package's VideoRegNet and optax.adam:
    ResNet-18 + bi-LSTM, two chunks, one of them padded, dropout 0."""
    m, lr = 2, 1e-3
    rng = np.random.RandomState(6)
    kw = dict(frame_shape=(RES, RES, 3), mlp_dim=(12, 10))
    jnet = JVideoRegNet(OUT, VH, FDIM, **kw)
    of = rng.randn(8, 2, RES, RES, 2)
    gt = rng.randn(8 - 2 * m, 2, OUT)
    mask = np.ones((8 - 2 * m, 2))
    mask[3:, 1] = 0.0
    variables = jax.device_get(jax.jit(jnet.init)(
        jax.random.PRNGKey(6), jnp.zeros((2, 1, RES, RES, 3))))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       variables)

    tx = optax.adam(lr)
    opt_state = tx.init(variables["params"])
    frames = jnp.concatenate([jnp.asarray(of), jnp.zeros(of.shape[:-1]
                                                         + (1,))], -1)

    def loss_fn(params):
        pred, upd = jnet.apply({**variables, "params": params}, frames,
                               train=True, mutable=["batch_stats"])
        pred = pred[m:-m]
        err = ((gt - pred) ** 2 * mask[..., None]).sum(-1)
        return err.sum() / jnp.maximum(mask.sum(), 1.0), upd

    (loss_j, upd), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    params_j = jax.jit(lambda g, s, p: optax.apply_updates(
        p, tx.update(g, s, p)[0]))(grads, opt_state, variables["params"])

    net = VideoRegNet(OUT, VH, FDIM, **kw).double()
    net.load_state_dict(video_reg_net_from_jax(variables))
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    captured = {}
    orig_step = opt.step

    def step_and_keep():
        captured.update({k: p.grad.clone()
                         for k, p in net.named_parameters()})
        orig_step()
    opt.step = step_and_keep
    loss_t = train_step(net, opt, torch.tensor(of), torch.tensor(gt),
                        torch.tensor(mask), m, torch.float64)
    _close(float(loss_t), float(loss_j), STEP_TOL)
    want = tree_to_state_dict(jax.device_get(grads),
                              variables["batch_stats"])
    assert set(captured) == {k for k in want if "running" not in k}
    for key, g in captured.items():
        _close(g.numpy(), want[key].numpy(), STEP_TOL)
    after = video_reg_net_to_jax(net.state_dict())
    _tree_close(after["params"], jax.device_get(params_j), STEP_TOL)
    _tree_close(after["batch_stats"], jax.device_get(upd["batch_stats"]),
                STEP_TOL)
