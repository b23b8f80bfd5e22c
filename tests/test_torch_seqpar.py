"""The port's sequence parallelism (egopose_tpu_torch/parallel/seqpar.py)
against the JAX package's, float64 on the CPU:

- ``tcn_halo`` and the TCN's ``t_mask`` (masked positions stay zero after
  every neighbourhood op) equal JAX's, the latter within 1e-10;
- ``vsnet_encode_sp`` (causal and not) and ``vregnet_apply_sp`` on 2 gloo
  ranks equal JAX's on a 2-device mesh of the conftest's virtual CPU
  devices within 1e-10, with the weights carried across; the time-sharded
  encode's gradients (the halo exchange's and the gather's adjoints),
  summed over the ranks, equal the unsharded pass's;
- the 2x2 data x time ego-mimic step with TCN context nets equals the
  one-process step at the JAX mesh test's bars;
- the rejections (LSTM context or temporal nets, thin chunks,
  ``train=True``) use the JAX messages.

The rank bodies live in egopose_tpu_torch/parallel/dryrun.py: a spawned
rank imports the module of the function it runs, and this module imports
JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egopose_tpu.models.tcn import TemporalConvNet as JTCN
from egopose_tpu.models.video_reg_net import VideoRegNet as JVideoRegNet
from egopose_tpu.models.video_state_net import VideoStateNet as JVideoStateNet
from egopose_tpu.parallel import seqpar as jseqpar
from egopose_tpu.parallel.mesh import make_mesh as jmake_mesh
from egopose_tpu_torch.convert import (context_from_jax, tree_to_state_dict,
                                       video_reg_net_from_jax)
from egopose_tpu_torch.models.tcn import TemporalConvNet
from egopose_tpu_torch.models.video_reg_net import VideoRegNet
from egopose_tpu_torch.models.video_state_net import VideoStateNet
from egopose_tpu_torch.parallel import dryrun, seqpar
from egopose_tpu_torch.parallel import mesh as meshlib

TOL = 1e-10
TCN = {"size": [16, 24], "dropout": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed):
    """Weights away from their initial values (biases nonzero)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + 0.05 * rng.randn(*np.shape(a)), jax.device_get(tree))


def test_tcn_halo_matches_jax():
    for args in (([64, 128], 3, False), ([64, 128], 3, True),
                 ([32], 5, False), ([8, 8, 8], 3, True)):
        assert seqpar.tcn_halo(*args) == jseqpar.tcn_halo(*args)


@pytest.mark.parametrize("causal", [False, True])
def test_tcn_t_mask_matches_jax(causal):
    """Positions outside the mask stay zero after every block, as in the
    JAX TCN."""
    jnet = JTCN([6, 8], 3, 0.0, causal)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 23, 5)
    mask = np.ones(23)
    mask[:4] = mask[-3:] = 0.0
    tree = _perturbed(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)), 0)
    net = TemporalConvNet(5, [6, 8], 3, 0.0, causal).double()
    net.load_state_dict(tree_to_state_dict(tree["params"]))
    got = net(torch.tensor(x), torch.tensor(mask)).detach().numpy()
    want = np.asarray(jnet.apply(tree, jnp.asarray(x), True,
                                 jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert not got[:, :4].any() and not got[:, -3:].any()


def _vsnet(causal, seed):
    """(JAX net, its perturbed tree, the port's constructor kwargs and
    state_dict) of a TCN VideoStateNet."""
    jnet = JVideoStateNet(8, 24, 5, "tcn", TCN, causal)
    tree = _perturbed(jnet.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, 40, 8), jnp.float64)), seed)
    kw = dict(cnn_feat_dim=8, v_hdim=24, v_margin=5, v_net_type="tcn",
              causal=causal, v_net_param=TCN)
    return jnet, tree, kw, context_from_jax(tree)


@pytest.mark.parametrize("causal", [False, True])
def test_vsnet_encode_sp_matches_jax(causal):
    """T=163 frames: not divisible by 2 (the tail padding), chunks above
    the causal halo."""
    jnet, tree, kw, sd = _vsnet(causal, 1)
    x = np.random.RandomState(1).randn(3, 163, 8)
    want = np.asarray(jseqpar.vsnet_encode_sp(jmake_mesh(2), jnet, tree,
                                              jnp.asarray(x)))
    outs = meshlib.launch(2, dryrun.sp_apply, "vsnet", 2, kw, sd, x,
                          torch.float64)
    for out in outs:
        np.testing.assert_allclose(out["out"].numpy(), want, rtol=0,
                                   atol=TOL)
    # the unsharded port equals JAX's unsharded pass too
    ref = dryrun.sp_apply("vsnet", 1, kw, sd, x, torch.float64,
                          causal_encode=causal)["out"].numpy()
    np.testing.assert_allclose(ref, np.asarray(jnet.apply(
        tree, jnp.asarray(x))), rtol=0, atol=TOL)


def test_vsnet_encode_sp_gradient_matches_unsharded():
    """The halo exchange's and the gather's adjoints: the parameters'
    gradient of a weighted sum of the time-sharded encode, summed over the
    ranks, is the unsharded pass's."""
    _, _, kw, sd = _vsnet(False, 2)
    rng = np.random.RandomState(2)
    x, gw = rng.randn(2, 70, 8), rng.randn(2, 60, 24)
    ref = dryrun.sp_apply("vsnet", 1, kw, sd, x, torch.float64,
                          grad_weights=gw)
    outs = meshlib.launch(2, dryrun.sp_apply, "vsnet", 2, kw, sd, x,
                          torch.float64, False, gw)
    assert float(ref["grad"].abs().max()) > 1e-3
    for out in outs:
        np.testing.assert_allclose(out["grad"].numpy(), ref["grad"].numpy(),
                                   rtol=0, atol=TOL)


def test_vregnet_apply_sp_matches_jax():
    jnet = JVideoRegNet(out_dim=12, v_hdim=24, cnn_fdim=8, no_cnn=True,
                        mlp_dim=(16,), v_net_type="tcn", v_net_param=TCN)
    x = np.random.RandomState(3).randn(163, 2, 8)           # (T, B, F)
    tree = _perturbed(jnet.init(jax.random.PRNGKey(3), jnp.asarray(x)), 3)
    want = np.asarray(jseqpar.vregnet_apply_sp(jmake_mesh(2), jnet, tree,
                                               jnp.asarray(x)))
    kw = dict(out_dim=12, v_hdim=24, cnn_fdim=8, no_cnn=True, mlp_dim=(16,),
              v_net_type="tcn", v_net_param=TCN)
    outs = meshlib.launch(2, dryrun.sp_apply, "vregnet", 2, kw,
                          video_reg_net_from_jax(tree), x, torch.float64)
    for out in outs:
        np.testing.assert_allclose(out["out"].numpy(), want, rtol=0,
                                   atol=TOL)


def test_dp_sp_step_matches_one_process():
    """One sample + update on a (2 data x 2 time) mesh, TCN context nets,
    against the one-process step: rewards rtol 1e-8 / atol 1e-10, metrics
    rtol 1e-6 / atol 1e-8 (tests/test_mesh.py's bars)."""
    one = dryrun.train_step(tcn=True)
    outs = meshlib.launch(4, dryrun.train_step, 2, 2, "float64", 8, 4,
                          False, True)
    for out in outs:
        lanes = slice(4 * out["data_rank"], 4 * out["data_rank"] + 4)
        np.testing.assert_allclose(out["rewards"].numpy(),
                                   one["rewards"][:, lanes].numpy(),
                                   rtol=1e-8, atol=1e-10)
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        # the time ranks encode their chunks and exchange halos
        kinds = {c.kind for c in out["audit_update"]}
        assert kinds == {"all-reduce", "all-gather"}
    # the time ranks of a lane shard hold the same parameters
    assert torch.equal(outs[0]["params"], outs[1]["params"])


class _Axes:
    """A stand-in mesh of 8 ranks on one axis: the guards below raise
    before any collective."""
    axis_names = ("data",)

    def size(self, axis=None):
        return 8


def test_rejections_use_the_jax_messages():
    vs = VideoStateNet(8, 16, 2, "lstm")
    with pytest.raises(ValueError, match="TCN"):
        seqpar.vsnet_encode_sp(_Axes(), vs, torch.zeros(1, 20, 8))
    reg = VideoRegNet(4, 16, 8, no_cnn=True, v_net_type="lstm")
    with pytest.raises(ValueError, match="TCN"):
        seqpar.vregnet_apply_sp(_Axes(), reg, torch.zeros(24, 1, 8))
    reg = VideoRegNet(4, 16, 8, no_cnn=True, v_net_type="tcn",
                      v_net_param={"size": [16, 16]})
    with pytest.raises(ValueError, match="inference-only"):
        seqpar.vregnet_apply_sp(_Axes(), reg, torch.zeros(24, 1, 8),
                                train=True)
    net = TemporalConvNet(8, [16, 24], 3, 0.0)
    with pytest.raises(ValueError, match="halo"):       # chunk 3 < halo 6
        seqpar.encode_time_sharded(_Axes(), net, torch.zeros(1, 24, 8), 6, 6)
