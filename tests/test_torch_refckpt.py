"""Reference-format checkpoints (the original PyTorch code's pickled
state_dicts, built here from the torch transcriptions of its modules in
the JAX package's tests) through the port's models/torch_import.py,
against the JAX package's torch_import on the same state_dicts, float64
on the CPU (1e-10 relative to the output's scale):

- TCN (causal and not), ResNet-18 and MobileNet with BatchNorm
  statistics, VideoRegNet (LSTM and TCN) and its statereg pickle through
  maybe_import_statereg (a full checkpoint with its CNN, and no_cnn);
- a reference ego-mimic checkpoint with a pickled ZFilter whose module is
  gone when it loads: AgentEgo.load, with LSTM and with TCN context nets,
  gives the JAX import's policy, value and context outputs and the
  filter's statistics;
- the reference-format forecast warm start: ego_forecast copies what the
  JAX import of the mimic checkpoint holds;
- a truncated reference checkpoint is refused."""
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from test_checkpoint_interop import TorchPolicy, TorchValue, TorchVSNet
from test_reference_ckpt_cli import (_install_reference_zfilter,
                                     _remove_reference_modules)
from test_torch_import import (TorchMobileNet, TorchResNet18, TorchTCN,
                               TorchVideoRegNet, _randomize_bn_stats)
from egopose_tpu.models import torch_import as jti
from egopose_tpu_torch.models import torch_import as ti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; the small CPU tensors
    here gain nothing from intra-op threads, which oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def _np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("causal", [False, True])
def test_tcn_import_matches_jax_import(causal):
    from egopose_tpu.models.tcn import TemporalConvNet as JTCN
    from egopose_tpu_torch.models.tcn import TemporalConvNet
    torch.manual_seed(2)
    ref = TorchTCN(6, [12, 16], k=3, causal=causal).double().eval()
    x = np.random.RandomState(2).randn(4, 20, 6)
    net = TemporalConvNet(6, [12, 16], 3, 0.2, causal).double().eval()
    net.load_state_dict(ti.import_tcn(ref.state_dict(), "", ""))
    want = JTCN([12, 16], 3, 0.2, causal).apply(
        {"params": jti.import_tcn(_np_sd(ref), "")}, jnp.asarray(x))
    with torch.no_grad():
        _close(net(torch.tensor(x)).numpy(), want)


def test_cnn_imports_match_jax_imports():
    from egopose_tpu.models.mobile_net import MobileNet as JMobileNet
    from egopose_tpu.models.resnet import ResNet18 as JResNet18
    from egopose_tpu_torch.models.mobile_net import MobileNet
    from egopose_tpu_torch.models.resnet import ResNet18
    torch.manual_seed(3)
    for ref, port, jnet, jimport, prefix, res in (
            (TorchResNet18(16), ResNet18(16), JResNet18(16),
             jti.import_resnet18, "resnet.", 64),
            (TorchMobileNet(8), MobileNet(8), JMobileNet(8),
             jti.import_mobile_net, "", 224)):
        ref = ref.double().eval()
        _randomize_bn_stats(ref, 3)
        sd = {prefix + k: v for k, v in ref.state_dict().items()}
        port = port.double().eval()
        port.load_state_dict(ti.import_resnet18(sd) if prefix
                             else ti.import_mobile_net(sd))
        x = np.random.RandomState(3).randn(1, res, res, 3)
        params, stats = jimport({k: v.numpy() for k, v in sd.items()},
                                prefix)
        want = jax.jit(jnet.apply)({"params": params, "batch_stats": stats},
                                   jnp.asarray(x))
        with torch.no_grad():
            _close(port(torch.tensor(x).permute(0, 3, 1, 2)).numpy(), want)


@pytest.mark.parametrize("v_net_type", ["lstm", "tcn"])
def test_statereg_checkpoint_import_matches_jax(v_net_type):
    """maybe_import_statereg on a reference pickle: a full VideoRegNet
    (the reference's ResNet under cnn.resnet.) and its no_cnn form."""
    from egopose_tpu.models.video_reg_net import VideoRegNet as JVideoRegNet
    from egopose_tpu_torch.models.video_reg_net import VideoRegNet
    torch.manual_seed(5)
    head = TorchVideoRegNet(7, 16, 10, (24, 12), v_net_type,
                            tcn_size=[12, 16]).double()
    cnn = TorchResNet18(10).double()
    _randomize_bn_stats(cnn, 5)
    sd = {**{"cnn.resnet." + k: v for k, v in cnn.state_dict().items()},
          **head.state_dict()}
    meta = {"mean": np.arange(7.0), "std": np.arange(1.0, 8.0)}
    kw = dict(v_net_type=v_net_type, v_net_param={"size": [12, 16]},
              mlp_dim=(24, 12))
    x = np.random.RandomState(5).randn(3, 2, 32, 32, 3)
    jvars = jti.import_video_reg_net(
        {k: v.numpy() for k, v in sd.items()}, v_net_type=v_net_type)
    for no_cnn in (False, True):
        got_sd, mean, std = ti.maybe_import_statereg(
            {"state_net_dict": sd}, meta, v_net_type=v_net_type,
            no_cnn=no_cnn)
        np.testing.assert_array_equal(mean, meta["mean"])
        np.testing.assert_array_equal(std, meta["std"])
        net = VideoRegNet(7, 16, 10, no_cnn=no_cnn,
                          frame_shape=(32, 32, 3), **kw).double().eval()
        net.load_state_dict(got_sd)
        jnet = JVideoRegNet(7, 16, 10, no_cnn=no_cnn,
                            frame_shape=(32, 32, 3), **kw)
        inp = x if not no_cnn else np.random.RandomState(6).randn(3, 2, 10)
        variables = jvars if not no_cnn else jti.strip_cnn(jvars)
        want = jax.jit(jnet.apply)(variables, jnp.asarray(inp))
        with torch.no_grad():
            _close(net(torch.tensor(inp)).numpy(), want)
    # the reference's own forward of the no_cnn head
    with torch.no_grad():
        _close(net(torch.tensor(inp)).numpy(),
               head(torch.tensor(inp)).numpy().reshape(3, 2, 7))


# -- agents -----------------------------------------------------------------

class TorchTCNVSNet(torch.nn.Module):
    """A reference VideoStateNet with a TCN temporal net (v_net.network)."""

    def __init__(self, fdim, size):
        super().__init__()
        self.v_net = TorchTCN(fdim, size)


FDIM, VH = 64, 128


@pytest.fixture(scope="module")
def world():
    """The synthetic subject_03 world on the CPU in float64, 1 take x 40
    frames."""
    from egopose_tpu_torch.cli.ego_mimic import build_world
    from egopose_tpu_torch.utils.config import EgoMimicConfig
    mp = pytest.MonkeyPatch()
    mp.chdir(REPO)
    try:
        cfg = EgoMimicConfig("subject_03")
        return cfg, build_world(cfg, torch.float64, "cpu", synthetic=True,
                                synthetic_takes=1, synthetic_len=40)
    finally:
        mp.undo()


def _reference_mimic_cp(obs_dim, nu, vs_nets, seed=0):
    ZFilter, RunningStat = _install_reference_zfilter()
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    zf = ZFilter(RunningStat(77, rng.randn(obs_dim), rng.rand(obs_dim) * 9))
    return {"policy_dict": TorchPolicy(obs_dim + VH, [300, 200], nu)
            .double().state_dict(),
            "policy_vs_dict": vs_nets[0].double().state_dict(),
            "value_dict": TorchValue(obs_dim + VH, [300, 200]).double()
            .state_dict(),
            "value_vs_dict": vs_nets[1].double().state_dict(),
            "running_state": zf}


@pytest.mark.parametrize("v_net", ["lstm", "tcn"])
def test_reference_mimic_checkpoint_loads_into_agent(world, tmp_path, v_net):
    from egopose_tpu.models.video_state_net import \
        VideoStateNet as JVideoStateNet
    from egopose_tpu.rl.nets import PolicyGaussian as JPolicy, Value as JValue
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    cfg, (spec, model, tables, p, expert, feats) = world
    param = {"size": [96, VH], "kernel_size": 3}
    if v_net == "tcn":
        cfg.policy_v_net = cfg.value_v_net = "tcn"
        cfg.policy_v_net_param = cfg.value_v_net_param = param
        vs = [TorchTCNVSNet(FDIM, [96, VH]) for _ in range(2)]
    else:
        vs = [TorchVSNet(FDIM, VH) for _ in range(2)]
    try:
        cp = _reference_mimic_cp(p.obs_dim, spec.nu, vs)
        path = str(tmp_path / "iter_0001.p")
        with open(path, "wb") as f:
            pickle.dump(cp, f)
        _remove_reference_modules()     # its ZFilter class is gone
        agent = AgentEgo(model, spec, p, tables, expert, feats, cfg,
                         batch_lanes=1, seed=1, dtype=torch.float64)
        agent.load(path)
    finally:
        cfg.policy_v_net = cfg.value_v_net = "lstm"
        cfg.policy_v_net_param = cfg.value_v_net_param = None
        _remove_reference_modules()
    jcp = jti.import_mimic_checkpoint(
        jti.tolerant_pickle_load(path), bi_dir=True, v_net_type=v_net)
    x = np.random.RandomState(1).randn(5, p.obs_dim + VH)
    with torch.no_grad():
        mean, log_std = agent.policy_net(torch.tensor(x))
        value = agent.value_net(torch.tensor(x))
    jmean, jlog_std = JPolicy(spec.nu, (300, 200), "relu").apply(
        jcp["policy_dict"], jnp.asarray(x))
    _close(mean.numpy(), jmean)
    _close(log_std.numpy(), jlog_std)
    _close(value.numpy(), JValue((300, 200), "relu").apply(
        jcp["value_dict"], jnp.asarray(x)))
    win = np.random.RandomState(2).randn(2, 30, FDIM)
    jvs = JVideoStateNet(FDIM, VH, cfg.fr_margin, v_net, param)
    for net, key in ((agent.policy_vs_net, "policy_vs_dict"),
                     (agent.value_vs_net, "value_vs_dict")):
        with torch.no_grad():
            _close(net(torch.tensor(win)).numpy(),
                   jvs.apply(jcp[key], jnp.asarray(win)))
    rs = jcp["running_state"]
    assert agent.zstat.n.dtype == torch.float64 and float(agent.zstat.n) == 77
    np.testing.assert_array_equal(agent.zstat.mean.numpy(), rs.mean)
    np.testing.assert_array_equal(agent.zstat.s.numpy(), rs.s)


def _forecast_dir(root, cp):
    cfg = yaml.safe_load(open(f"{REPO}/config/egoforecast/"
                              "subject_03_syn.yml"))
    cfg.update(dict(ego_mimic_cfg="ref", ego_mimic_iter=1, fr_margin=5,
                    env_episode_len=8))
    cfg.pop("meta_id", None)
    os.makedirs(root / "config" / "egoforecast")
    os.makedirs(root / "config" / "egomimic")
    yaml.safe_dump(cfg, open(root / "config" / "egoforecast" / "tiny.yml",
                             "w"))
    em = yaml.safe_load(open(f"{REPO}/config/egomimic/subject_03.yml"))
    yaml.safe_dump(em, open(root / "config" / "egomimic" / "ref.yml", "w"))
    models = root / "results" / "egomimic" / "ref" / "models"
    os.makedirs(models)
    with open(models / "iter_0001.p", "wb") as f:
        pickle.dump(cp, f)
    return root


def test_reference_forecast_warm_start(world, tmp_path, monkeypatch):
    """ego_forecast's warm start from a reference-format mimic checkpoint:
    every policy and value leaf whose shape fits is the JAX import's."""
    from egopose_tpu_torch.cli import ego_forecast
    from egopose_tpu_torch.convert import params_to_jax
    _, (spec, _, _, p, _, _) = world
    try:
        cp = _reference_mimic_cp(p.obs_dim, spec.nu,
                                 [TorchVSNet(FDIM, VH) for _ in range(2)])
        _forecast_dir(tmp_path, cp)
    finally:
        _remove_reference_modules()
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_TAKES", "1")
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_LEN", "40")
    agent = ego_forecast.main(["--cfg", "tiny", "--synthetic", "--device",
                               "cpu", "--f64", "--batch-lanes", "2",
                               "--max-iter", "0"])
    jcp = jti.import_mimic_checkpoint(
        jti.tolerant_pickle_load(str(tmp_path / "results" / "egomimic" /
                                     "ref" / "models" / "iter_0001.p")))
    pol, _, val, _ = params_to_jax(*[n.state_dict() for n in agent.nets])
    for mine, theirs in ((pol, jcp["policy_dict"]),
                         (val, jcp["value_dict"])):
        net_m, net_t = mine["params"]["net"], theirs["params"]["net"]
        # the first layer's input differs (mimic obs + v_hdim vs forecast
        # context): its kernel stays the forecast agent's own
        assert net_m["Dense_0"]["kernel"].shape \
            != net_t["Dense_0"]["kernel"].shape
        np.testing.assert_array_equal(net_m["Dense_0"]["bias"],
                                      net_t["Dense_0"]["bias"])
        np.testing.assert_array_equal(net_m["Dense_1"]["kernel"],
                                      net_t["Dense_1"]["kernel"])
    np.testing.assert_array_equal(
        pol["params"]["action_mean"]["kernel"],
        np.asarray(jcp["policy_dict"]["params"]["action_mean"]["kernel"]))


def test_truncated_reference_checkpoint_is_refused():
    with pytest.raises(KeyError):
        ti.import_mimic_checkpoint({"policy_dict": {"net.0.weight":
                                                    np.zeros((2, 2))}})
