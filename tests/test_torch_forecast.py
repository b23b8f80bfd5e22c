"""The ego-forecast modules of egopose_tpu_torch against the JAX package's,
float64 on the CPU (small nets carried across by params_from_jax):

- VideoForecastNet: encode_video, s_step and s_batch to 1e-12 (the same
  LSTM arithmetic); RNN.step is one step of the batch unroll; the trees
  carry across both ways;
- sync_traj to 1e-12 and step_autoreset to 1e-9 (one control step);
- one forecast segment (B=4, T=8, fr_margin=5, 2 synthetic takes x 64
  frames) with JAX's random numbers injected: states, actions, rewards,
  masks, fails, the rest of the SegmentBatch and the ZFilter to 1e-9.
  Take 0's head bound is raised so its lanes fail, re-anchor and restart
  their state-LSTM carry every step;
- one PPO update with the forecast context on that segment: all four
  nets to 1e-8 after two epochs;
- the warm start from the committed ego-mimic iter_3000.p: the leaves the
  JAX warmstart_from_mimic copies equal the port's, and the port drops
  the same ones."""
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu import envs as jenvs
from egopose_tpu.models.torch_import import tolerant_pickle_load
from egopose_tpu.models.video_forecast_net import (
    VideoForecastNet as JForecastNet)
from egopose_tpu.ops import running_norm as jrn
from egopose_tpu.physics import build_model as jbuild
from egopose_tpu.physics.spec import parse_mjcf as jparse
from egopose_tpu.rl import agent_forecast as jaf, ppo as jppo
from egopose_tpu.rl.nets import PolicyGaussian as JPolicy, Value as JValue
from egopose_tpu.utils import config as jcfg
from egopose_tpu.utils.tools import sync_traj as jsync_traj
from egopose_tpu_torch import envs as tenvs
from egopose_tpu_torch.convert import (context_from_jax, context_to_jax,
                                       load_checkpoint_pickle,
                                       params_from_jax, params_to_jax)
from egopose_tpu_torch.models.rnn import RNN
from egopose_tpu_torch.models.video_forecast_net import VideoForecastNet
from egopose_tpu_torch.ops import running_norm as trn
from egopose_tpu_torch.physics import model as tmodel
from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
from egopose_tpu_torch.rl import agent_forecast as taf, ppo as tppo
from egopose_tpu_torch.rl import rollout as trollout
from egopose_tpu_torch.rl.nets import PolicyGaussian, Value
from egopose_tpu_torch.utils import config as tcfg
from egopose_tpu_torch.utils.tools import sync_traj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
EXACT = 1e-12    # the same LSTM / quaternion arithmetic
SEG_TOL = 1e-9   # eight control steps of the same physics
PPO_TOL = 1e-8   # two epochs of Adam through both LSTMs and the MLPs
B, T, M, N_TAKES, T_LEN = 4, 8, 5, 2, 64
FEAT, VH, SH, HID, OBS = 6, 8, 7, (16, 12), 115
NOISE_RATE = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _init_forecast(net, key, feat, state_dim, margin):
    """The JAX agent's init: encode_video's and s_batch's trees merged."""
    v = net.init(key, jnp.zeros((1, margin, feat)), method=net.encode_video)
    if net.s_net_type == "lstm":
        v2 = net.init(key, jnp.zeros((2, 1, state_dim)), method=net.s_batch)
        v = {"params": {**v["params"], **v2["params"]}}
    return _f64(v)


def _port_net(tree, *args, **kw):
    net = VideoForecastNet(*args, **kw).double()
    net.load_state_dict(context_from_jax(tree))
    return net


@pytest.mark.parametrize("s_net", ["lstm", "id"])
def test_forecast_net_matches_jax(s_net):
    s_hdim = SH if s_net == "lstm" else None
    jnet = JForecastNet(FEAT, 9, VH, M, "lstm", None, s_hdim, s_net)
    tree = _init_forecast(jnet, jax.random.PRNGKey(0), FEAT, 9, M)
    net = _port_net(tree, FEAT, 9, VH, M, "lstm", s_hdim, s_net)
    assert net.out_dim == jnet.out_dim == VH + (SH if s_hdim else 9)
    rng = np.random.RandomState(0)
    win, states = rng.randn(3, M, FEAT), rng.randn(4, 3, 9)
    with torch.no_grad():
        np.testing.assert_allclose(
            net.encode_video(torch.tensor(win)).numpy(),
            np.asarray(jnet.apply(tree, jnp.asarray(win),
                                  method=jnet.encode_video)),
            rtol=0, atol=EXACT)
        np.testing.assert_allclose(
            net.s_batch(torch.tensor(states)).numpy(),
            np.asarray(jnet.apply(tree, jnp.asarray(states),
                                  method=jnet.s_batch)),
            rtol=0, atol=EXACT)
        carry_t = net.s_init_carry((3,), torch.zeros(1, dtype=torch.float64))
        carry_j = jnet.s_init_carry((3,), jnp.float64)
        for t in range(states.shape[0]):
            carry_t, out_t = net.s_step(carry_t, torch.tensor(states[t]))
            carry_j, out_j = jnet.apply(tree, carry_j, jnp.asarray(states[t]),
                                        method=jnet.s_step)
            np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                       rtol=0, atol=EXACT)
        # the update's context: the video context over T, then s_batch
        ctx = net.context(torch.tensor(win), torch.tensor(states))
        assert ctx.shape == (4, 3, net.out_dim)
        np.testing.assert_array_equal(ctx[2, :, :VH].numpy(),
                                      net.encode_video(
                                          torch.tensor(win)).numpy())
    # the trees carry back unchanged
    back = context_to_jax(net.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


def test_rnn_step_is_one_step_of_the_unroll():
    torch.manual_seed(0)
    rnn = RNN(5, 6).double()
    x = torch.randn(4, 3, 5, dtype=torch.float64)
    with torch.no_grad():
        full = rnn(x)
        carry = rnn.init_carry((3,), x)
        for t in range(4):
            carry, h = rnn.step(carry, x[t])
            assert torch.equal(h, full[t])


def test_unported_context_options_raise():
    # the TCN context net is ported (tests/test_torch_statereg_nets.py);
    # an unknown context net type is refused, as by the JAX package
    with pytest.raises(ValueError, match="gru"):
        VideoForecastNet(FEAT, 9, VH, M, "gru")
    with pytest.raises(NotImplementedError, match="ROADMAP §3"):
        VideoForecastNet(FEAT, 9, VH, M, "lstm", dynamic_v=True)


def _unit_quats(rng, n):
    q = rng.randn(n, 4)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_sync_traj_matches_jax():
    rng = np.random.RandomState(1)
    qpos, qvel, ref = rng.randn(12, 59), rng.randn(12, 58), rng.randn(59)
    qpos[:, 3:7] = _unit_quats(rng, 12)
    ref[3:7] = _unit_quats(rng, 1)[0]
    got, want = sync_traj(qpos, qvel, ref), jsync_traj(qpos, qvel, ref)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=EXACT)


@pytest.fixture(scope="module")
def worlds():
    root = os.path.join(REPO, "config")
    jc = jcfg.EgoForecastConfig("subject_03_syn", config_root=root)
    tc = tcfg.EgoForecastConfig("subject_03_syn", config_root=root)
    for c in (jc, tc):
        c.env_episode_len, c.fr_margin, c.env_init_noise = T, M, 0.05
    jspec, tspec = jparse(XML), tparse(XML)
    jm = jbuild(jspec, dtype=jnp.float64)
    tm = tmodel.build_model(tspec, dtype=torch.float64)
    jp = jcfg.make_env_params(jc, jspec, obs_dim=OBS, dtype=np.float64)
    tp = tcfg.make_env_params(tc, tspec, obs_dim=OBS, dtype=torch.float64)
    jt, tt = jenvs.make_body_tables(jspec), tenvs.make_body_tables(tspec)
    je = jenvs.synthetic_experts(jm, jp, jt, jspec, N_TAKES, T_LEN, seed=1)
    te = tenvs.synthetic_experts(tm, tp, tt, tspec, N_TAKES, T_LEN, seed=1)
    # take 0's lanes fail every step: its head bound is above any head
    je = je._replace(head_height_lb=je.head_height_lb.at[0].set(5.0))
    hl = te.head_height_lb.clone()
    hl[0] = 5.0
    te = te._replace(head_height_lb=hl)
    return (jm, jp, jt, je), (tm, tp, tt, te)


def _jax_reset_draws(jw, keys):
    """What envs.reset draws from each key, as the port's reset draws."""
    jm, jp, jt, je = jw
    st = jax.vmap(lambda kk: jenvs.reset(jm, jp, jt, je, kk))(keys)
    init = jax.vmap(lambda kk: jax.random.normal(
        jax.random.split(kk, 4)[2], (jp.nq - 7,), jnp.float64))(keys)
    t = lambda x: torch.tensor(np.asarray(x))
    return (t(st.expert_ind).long(), t(st.start_ind).long(),
            t(st.cur_t).long(), t(init)), st


def _jax_noise(jw, key):
    """What the JAX forecast rollout draws from ``key``."""
    p = jw[1]
    k_reset, k_scan = jax.random.split(key)
    reset, _ = _jax_reset_draws(jw, jax.random.split(k_reset, B))
    normal = lambda kk: jax.random.normal(kk, (p.nq - 7,), jnp.float64)
    gate, act, anchor = [], [], []
    for kt in jax.random.split(k_scan, T):
        k_gate, k_act, k_anchor = jax.random.split(kt, 3)
        gate.append(jax.random.bernoulli(k_gate, NOISE_RATE, (B,)))
        act.append(jax.random.normal(k_act, (B, p.nu), jnp.float64))
        anchor.append(jax.vmap(normal)(jax.random.split(k_anchor, B)))
    t = lambda x: torch.tensor(np.asarray(x))
    return trollout.SegmentNoise(
        *reset, gate=t(np.stack(gate)), act_noise=t(np.stack(act)),
        anchor_noise=t(np.stack(anchor)))


def test_step_autoreset_matches_jax(worlds):
    jw, tw = worlds
    jm, jp, jt, je = jw
    tm, tp, tt, te = tw
    keys = jax.random.split(jax.random.PRNGKey(4), 2 * B)
    _, st = _jax_reset_draws(jw, keys[:B])
    st = st._replace(done=jnp.array([True, False, True, False]))
    draws, _ = _jax_reset_draws(jw, keys[B:])
    action = np.random.RandomState(5).randn(B, jp.nu) * 0.3
    jst, jout, jwas = jax.jit(jax.vmap(
        lambda s, a, kk: jenvs.step_autoreset(jm, jp, jt, je, s, a, kk,
                                              0.3)))(
        st, jnp.asarray(action), keys[B:])
    tst = tenvs.EnvState(*[torch.tensor(np.asarray(x)) for x in st])
    tst = tst._replace(cur_t=tst.cur_t.long(),
                       expert_ind=tst.expert_ind.long(),
                       start_ind=tst.start_ind.long())
    nst, out, was = tenvs.step_autoreset(tm, tp, tt, te, tst,
                                         torch.tensor(action), draws, 0.3)
    np.testing.assert_array_equal(was.numpy(), np.asarray(jwas))
    for name in tenvs.EnvState._fields:
        np.testing.assert_allclose(
            getattr(nst, name).double().numpy(),
            np.asarray(getattr(jst, name), np.float64), rtol=0,
            atol=SEG_TOL, err_msg=name)
    for name in ("obs", "reward", "done", "fail", "reward_info"):
        np.testing.assert_allclose(
            getattr(out, name).double().numpy(),
            np.asarray(getattr(jout, name), np.float64), rtol=0,
            atol=SEG_TOL, err_msg=name)
    assert (out.reward[was] == 0).all() and not out.done[was].any()


@pytest.fixture(scope="module")
def segment(worlds):
    """One forecast segment through both packages from the same weights
    and random numbers, and the trees of the four nets."""
    jw, tw = worlds
    jm, jp, jt, je = jw
    tm, tp, tt, te = tw
    cnn = np.random.RandomState(8).randn(N_TAKES, T_LEN, FEAT)
    k = jax.random.split(jax.random.PRNGKey(2), 4)
    jvs = JForecastNet(FEAT, OBS, VH, M, "lstm", None, SH, "lstm")
    jpol = JPolicy(52, HID, "relu", -1.0)
    x0 = jnp.zeros((1, VH + SH))
    trees = (_f64(jpol.init(k[0], x0)),
             _init_forecast(jvs, k[1], FEAT, OBS, M),
             _f64(JValue(HID, "relu").init(k[2], x0)),
             _init_forecast(jvs, k[3], FEAT, OBS, M))
    key = jax.random.PRNGKey(9)
    jseg, jz = jax.jit(lambda kk: jaf.rollout_segment_forecast(
        jm, jp, jt, je, jnp.asarray(cnn), jpol.apply, trees[0], jvs,
        trees[1], jrn.init_stat(OBS, jnp.float64), kk, B, NOISE_RATE,
        end_reward=0.3))(key)

    sd_p, sd_vs, _, _ = params_from_jax(*trees)
    pol = PolicyGaussian(VH + SH, 52, HID, "relu", -1.0).double()
    pol.load_state_dict(sd_p)
    vs = VideoForecastNet(FEAT, OBS, VH, M, "lstm", SH, "lstm").double()
    vs.load_state_dict(sd_vs)
    tseg, tz = taf.rollout_segment_forecast(
        tm, tp, tt, te, torch.tensor(cnn), pol, vs,
        trn.init_stat(OBS, torch.float64), _jax_noise(jw, key),
        end_reward=0.3)
    return cnn, trees, (jseg, jz), (tseg, tz)


def test_forecast_segment_matches_jax(segment):
    _, _, (jseg, jz), (tseg, tz) = segment
    for name in trollout.SegmentBatch._fields:
        got, want = getattr(tseg, name), np.asarray(getattr(jseg, name))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                   atol=SEG_TOL, err_msg=name)
    for name in ("n", "mean", "s"):
        np.testing.assert_allclose(getattr(tz, name).numpy(),
                                   np.asarray(getattr(jz, name)), rtol=0,
                                   atol=SEG_TOL, err_msg="zstat " + name)
    assert 0 < tseg.exps.mean() < 1                 # gates both ways
    # take 0's lanes re-anchor (and restart their carry) every step, the
    # others carry theirs through
    on_take0 = tseg.expert_ind == 0
    assert on_take0.any() and (~on_take0).any()
    assert (tseg.fails[:, on_take0] == 1).all()
    assert (tseg.masks[:, on_take0] == 0).all()


def test_gather_past_windows_clamps_like_jax():
    feat = np.random.RandomState(3).randn(3, 30, 4)
    e, s = np.array([0, 1, 2, 1]), np.array([1, 12, 29, 3])
    want = jaf.gather_past_windows(jnp.asarray(feat), jnp.asarray(e),
                                   jnp.asarray(s), 5)
    got = taf.gather_past_windows(torch.tensor(feat), torch.tensor(e),
                                  torch.tensor(s), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forecast_ppo_update_matches_jax(segment):
    cnn, trees, (jseg, _), _ = segment
    jvs = JForecastNet(FEAT, OBS, VH, M, "lstm", None, SH, "lstm")
    jpol, jval = JPolicy(52, HID, "relu", -1.0), JValue(HID, "relu")

    def ctx(p_vs, windows, states):
        v = jvs.apply(p_vs, windows, method=jvs.encode_video)
        v = jnp.broadcast_to(v[None], (states.shape[0],) + v.shape)
        return jnp.concatenate(
            [v, jvs.apply(p_vs, states, method=jvs.s_batch)], -1)

    opt_kw = dict(policy_lr=3e-3, value_lr=1e-2, grad_clip=40.0)
    opt_p, opt_v = jppo.make_optimizers(**opt_kw)
    hyper = jppo.PPOHyper(num_epochs=2)
    jwin = jaf.gather_past_windows(jnp.asarray(cnn), jseg.expert_ind,
                                   jseg.start_ind, M)
    ts_j = jppo.TrainState(
        policy=trees[0], policy_vs=trees[1], value=trees[2],
        value_vs=trees[3], opt_policy=opt_p.init((trees[0], trees[1])),
        opt_value=opt_v.init((trees[2], trees[3])))
    ts_j, m_j = jax.jit(lambda ts, b, w: jppo.ppo_update(
        ts, opt_p, opt_v, hyper, b, w, jpol.apply, ctx, jval.apply,
        ctx))(ts_j, jseg, jwin)

    nets = [PolicyGaussian(VH + SH, 52, HID, "relu", -1.0),
            VideoForecastNet(FEAT, OBS, VH, M, "lstm", SH, "lstm"),
            Value(VH + SH, HID, "relu"),
            VideoForecastNet(FEAT, OBS, VH, M, "lstm", SH, "lstm")]
    for net, sd in zip(nets, params_from_jax(*trees)):
        net.double().load_state_dict(sd)
    opt_tp, opt_tv = tppo.make_optimizers(
        [*nets[0].parameters(), *nets[1].parameters()],
        [*nets[2].parameters(), *nets[3].parameters()], **opt_kw)
    ts_t = tppo.TrainState(*nets, opt_policy=opt_tp, opt_value=opt_tv)
    batch = trollout.SegmentBatch(*[torch.tensor(np.asarray(x))
                                    for x in jseg])
    windows = taf.gather_past_windows(torch.tensor(cnn), batch.expert_ind,
                                      batch.start_ind, M)
    _, m_t = tppo.ppo_update(ts_t, tppo.PPOHyper(num_epochs=2), batch,
                             windows)

    moved = np.abs(np.asarray(ts_j.policy_vs["params"]["s_net"]["rnn_f"]
                              ["hh"]["kernel"])
                   - trees[1]["params"]["s_net"]["rnn_f"]["hh"]["kernel"])
    assert moved.max() > 1e-5           # the state LSTM learned too
    got = params_to_jax(*[n.state_dict() for n in nets])
    for g, w in zip(got, ts_j[:4]):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                    rtol=0, atol=PPO_TOL),
            g, w)
    for name in ("policy_loss", "value_loss"):
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]),
                                   rtol=0, atol=PPO_TOL, err_msg=name)


def test_warmstart_from_committed_mimic_checkpoint():
    path = os.path.join(REPO, "results", "egomimic", "subject_03", "models",
                        "iter_3000.p")
    k = jax.random.split(jax.random.PRNGKey(6), 2)
    x0 = jnp.zeros((1, 256))
    pol = _f64(JPolicy(52, (300, 200), "relu", -1.0).init(k[0], x0))
    val = _f64(JValue((300, 200), "relu").init(k[1], x0))
    ts = jppo.TrainState(policy=pol, policy_vs=None, value=val,
                         value_vs=None, opt_policy=None, opt_value=None)
    warm = jaf.warmstart_from_mimic(ts, tolerant_pickle_load(path))

    sd_p, _, sd_v, _ = params_from_jax(pol, {}, val, {})
    agent = types.SimpleNamespace(
        policy_net=PolicyGaussian(256, 52, (300, 200), "relu").double(),
        value_net=Value(256, (300, 200), "relu").double())
    agent.policy_net.load_state_dict(sd_p)
    agent.value_net.load_state_dict(sd_v)
    copied = taf.warmstart_from_mimic(agent, load_checkpoint_pickle(path))

    after_p, _, after_v, _ = params_from_jax(warm.policy, {}, warm.value,
                                             {})
    for name, before, after, net in (
            ("policy", sd_p, after_p, agent.policy_net),
            ("value", sd_v, after_v, agent.value_net)):
        mine = net.state_dict()
        for key in before:
            assert torch.equal(mine[key], after[key].double()), key
        # the leaves the JAX warm start changed are the ones the port
        # copied: all but the first layer's weight
        changed = sorted(key for key in before
                         if not torch.equal(after[key].double(), before[key]))
        assert copied[name] == changed, name
        assert "net.layers.0.weight" not in changed
        assert "net.layers.1.weight" in changed


def test_agent_forecast_sizes_its_nets(worlds):
    _, (tm, tp, tt, te) = worlds
    cfg = tcfg.EgoForecastConfig("subject_03_syn",
                                 config_root=os.path.join(REPO, "config"))
    assert cfg.policy_kl_target == 0.05 and cfg.end_reward is False
    cfg.update_adaptive_params(600)
    assert cfg.adp_init_noise == 0.0
    spec = tparse(XML)
    agent = taf.AgentForecast(tm, spec, tp, tt, te,
                              np.zeros((N_TAKES, T_LEN, FEAT)), cfg,
                              batch_lanes=2, dtype=torch.float64)
    assert agent.policy_net.net.layers[0].in_features == 256
    assert agent.value_net.net.layers[0].in_features == 256
    assert agent.hyper.kl_target == 0.05
    assert isinstance(agent.policy_vs_net, VideoForecastNet)
    assert agent.objective == "ppo" and agent.trpo_hyper is None
    cfg.policy_objective = "ddpg"
    with pytest.raises(ValueError, match="policy_objective"):
        taf.AgentForecast(tm, spec, tp, tt, te,
                          np.zeros((N_TAKES, T_LEN, FEAT)), cfg,
                          batch_lanes=2, dtype=torch.float64)
