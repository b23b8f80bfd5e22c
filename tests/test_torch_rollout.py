"""rollout_segment of egopose_tpu_torch against the JAX package's, float64
on the CPU (B=4 lanes, T=5 steps, 2 synthetic takes, small nets carried
across by params_from_jax).  Random paths are compared by injecting the
same noise: the port's SegmentNoise is filled with what the JAX rollout
draws from its keys (reset indices and joint noise, Bernoulli gates, action
noise, re-anchor noise).  States, actions, rewards, masks, exps, fails,
reward_info, expert/start indices and the final zstat agree to 1e-8.
Take 0's head bound is raised so its lanes fail (and are re-anchored) every
step; with random_cur_t, episode ends re-anchor instead.  gather_windows
indexes a window that starts before or ends after its take as
jax.lax.dynamic_slice_in_dim does."""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu import envs as jenvs
from egopose_tpu.models.video_state_net import VideoStateNet as JVideoStateNet
from egopose_tpu.ops import running_norm as jrn
from egopose_tpu.physics import build_model as jbuild
from egopose_tpu.physics.spec import parse_mjcf as jparse
from egopose_tpu.rl import rollout as jrollout
from egopose_tpu.rl.nets import PolicyGaussian as JPolicy, Value as JValue
from egopose_tpu.utils import config as jcfg
from egopose_tpu_torch import envs as tenvs
from egopose_tpu_torch.convert import params_from_jax
from egopose_tpu_torch.models.video_state_net import VideoStateNet
from egopose_tpu_torch.ops import running_norm as trn
from egopose_tpu_torch.physics import model as tmodel
from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
from egopose_tpu_torch.rl import rollout as trollout
from egopose_tpu_torch.rl.nets import PolicyGaussian
from egopose_tpu_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
TOL = 1e-8   # five control steps of the same physics, summed differently
B, T, N_TAKES, T_LEN, FEAT, VH, HID = 4, 5, 2, 40, 6, 8, (16, 12)
NOISE_RATE, END_REWARD = 0.5, 0.3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds():
    root = os.path.join(REPO, "config")
    jc = jcfg.EgoMimicConfig("subject_03", config_root=root)
    tc = tcfg.EgoMimicConfig("subject_03", config_root=root)
    for c in (jc, tc):
        c.env_episode_len, c.env_init_noise = T, 0.05
    jspec, tspec = jparse(XML), tparse(XML)
    jm = jbuild(jspec, dtype=jnp.float64)
    tm = tmodel.build_model(tspec, dtype=torch.float64)
    jp = jcfg.make_env_params(jc, jspec, obs_dim=115, dtype=np.float64)
    tp = tcfg.make_env_params(tc, tspec, obs_dim=115, dtype=torch.float64)
    jt, tt = jenvs.make_body_tables(jspec), tenvs.make_body_tables(tspec)
    je = jenvs.synthetic_experts(jm, jp, jt, jspec, N_TAKES, T_LEN, seed=1)
    te = tenvs.synthetic_experts(tm, tp, tt, tspec, N_TAKES, T_LEN, seed=1)
    # take 0's lanes fail every step: its head bound is above any head
    je = je._replace(head_height_lb=je.head_height_lb.at[0].set(5.0))
    hl = te.head_height_lb.clone()
    hl[0] = 5.0
    te = te._replace(head_height_lb=hl)
    rng = np.random.RandomState(8)
    cnn = rng.randn(N_TAKES, T_LEN, FEAT)
    k = jax.random.split(jax.random.PRNGKey(2), 3)
    f64 = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), t)
    x0 = jnp.zeros((1, 115 + VH))
    vs = f64(JVideoStateNet(FEAT, VH, jc.fr_margin, "lstm").init(
        k[1], jnp.zeros((1, T + 2 * jc.fr_margin, FEAT))))
    # (policy, policy_vs, value, value_vs); the rollout uses the first two
    trees = (f64(JPolicy(52, HID, "relu", -1.0).init(k[0], x0)), vs,
             f64(JValue(HID, "relu").init(k[2], x0)), vs)
    return (jm, jp, jt, je), (tm, tp, tt, te), cnn, trees


def _jax_noise(jw, key, p):
    """What the JAX rollout draws from ``key``, as a SegmentNoise."""
    jm, _, jt, je = jw
    k_reset, k_scan = jax.random.split(key)
    reset_keys = jax.random.split(k_reset, B)
    st = jax.vmap(lambda kk: jenvs.reset(jm, p, jt, je, kk))(reset_keys)
    normal = lambda kk: jax.random.normal(kk, (p.nq - 7,), jnp.float64)
    init = jax.vmap(lambda kk: normal(jax.random.split(kk, 4)[2]))(
        reset_keys)
    gate, act, anchor = [], [], []
    for kt in jax.random.split(k_scan, T):
        k_gate, k_act, k_anchor = jax.random.split(kt, 3)
        gate.append(jax.random.bernoulli(k_gate, NOISE_RATE, (B,)))
        act.append(jax.random.normal(k_act, (B, p.nu), jnp.float64))
        anchor.append(jax.vmap(normal)(jax.random.split(k_anchor, B)))
    t = lambda x: torch.tensor(np.asarray(x))
    return trollout.SegmentNoise(
        expert_ind=t(st.expert_ind).long(), start_ind=t(st.start_ind).long(),
        cur_t0=t(st.cur_t).long(), init_noise=t(init),
        gate=t(np.stack(gate)), act_noise=t(np.stack(act)),
        anchor_noise=t(np.stack(anchor)))


@pytest.mark.parametrize("random_cur_t", [False, True])
def test_rollout_segment_matches_jax(worlds, random_cur_t):
    jw, tw, cnn, trees = worlds
    jm, jp, jt, je = jw
    tm, tp, tt, te = tw
    jp = dataclasses.replace(jp, random_cur_t=random_cur_t)
    tp = dataclasses.replace(tp, random_cur_t=random_cur_t)
    jpol = JPolicy(52, HID, "relu", -1.0)
    jvs = JVideoStateNet(FEAT, VH, jp.fr_margin, "lstm")
    key = jax.random.PRNGKey(9)
    jseg, jz = jax.jit(lambda kk: jrollout.rollout_segment(
        jm, jp, jt, je, jnp.asarray(cnn), jpol.apply, trees[0], jvs.apply,
        trees[1], jrn.init_stat(115, jnp.float64), kk, B, NOISE_RATE,
        end_reward=END_REWARD))(key)

    sd_p, sd_vs, _, _ = params_from_jax(*trees)
    pol = PolicyGaussian(115 + VH, 52, HID, "relu", -1.0).double()
    pol.load_state_dict(sd_p)
    vs = VideoStateNet(FEAT, VH, tp.fr_margin).double()
    vs.load_state_dict(sd_vs)
    noise = _jax_noise(jw, key, jp)
    tseg, tz = trollout.rollout_segment(
        tm, tp, tt, te, torch.tensor(cnn), pol, vs,
        trn.init_stat(115, torch.float64), noise, end_reward=END_REWARD)

    for name in trollout.SegmentBatch._fields:
        got, want = getattr(tseg, name), np.asarray(getattr(jseg, name))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                   atol=TOL, err_msg=name)
    for name in ("n", "mean", "s"):
        np.testing.assert_allclose(getattr(tz, name).numpy(),
                                   np.asarray(getattr(jz, name)), rtol=0,
                                   atol=TOL, err_msg="zstat " + name)
    assert 0 < tseg.exps.mean() < 1                 # gates both ways
    assert tseg.fails.sum() > 0 and (tseg.masks == 0).any()
    if not random_cur_t:
        on_take0 = (tseg.expert_ind == 0)
        assert on_take0.any() and (tseg.fails[:, on_take0] == 1).all()


def test_gather_windows_clamps_like_jax():
    rng = np.random.RandomState(3)
    feat = rng.randn(3, 30, 4)
    e = np.array([0, 1, 2, 1])
    s = np.array([1, 12, 29, 5])              # before / inside / after
    want = jrollout.gather_windows(jnp.asarray(feat), jnp.asarray(e),
                                   jnp.asarray(s), 3, 8)
    got = trollout.gather_windows(torch.tensor(feat), torch.tensor(e),
                                  torch.tensor(s), 3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
