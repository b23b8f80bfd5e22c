"""The port's VGAIL (egopose_tpu_torch/rl/vgail.py) and discrete policy
against the JAX package's, float64 on the CPU, on weights carried across
by convert.py:

- gail_reward, update_discriminator (3 BCE steps with the clip-40 Adam)
  and gather_expert_obs (windows clamped inside the take, as
  dynamic_slice_in_dim does) to 1e-9;
- AgentVGAIL.update_params on an injected batch (reward_weight 0.7: the
  blended reward, then PPO, then the discriminator): the policy, value and
  discriminator nets and discrim_loss to 1e-8;
- a reward_weight outside (0, 1] raises;
- PolicyDiscrete's logits to 1e-12."""
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu.models.video_state_net import VideoStateNet as JVideoStateNet
from egopose_tpu.ops import running_norm as jrn
from egopose_tpu.rl import vgail as jvgail
from egopose_tpu.rl.nets import PolicyDiscrete as JPolicyDiscrete
from egopose_tpu.rl.rollout import SegmentBatch as JSegmentBatch
from egopose_tpu_torch.convert import (discriminator_from_jax,
                                       params_to_jax,
                                       policy_discrete_from_jax)
from egopose_tpu_torch.models.video_state_net import VideoStateNet
from egopose_tpu_torch.ops import running_norm as trn
from egopose_tpu_torch.rl import vgail as tvgail
from egopose_tpu_torch.rl.nets import PolicyDiscrete
from egopose_tpu_torch.rl.rollout import SegmentBatch
from test_torch_trpo import _close_trees, as_f64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
AGENT_TOL = 1e-8
T, B, OBS, VH, FEAT, M, N_TAKES, T_TAKE = 6, 4, 9, 8, 6, 3, 2, 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stat(obs_dim, seed):
    """A RunningStat fed seeded observations, in both packages."""
    x = np.random.RandomState(seed).randn(50, obs_dim) * 0.7 + 0.3
    js = jrn.push_batch(jrn.init_stat(obs_dim, jnp.float64), jnp.asarray(x))
    return js, trn.RunningStat(*[torch.tensor(np.asarray(a)) for a in js])


@pytest.fixture(scope="module")
def disc_case():
    """The JAX discriminator (float64) and the port's on its weights, with
    windows, generator states and expert observations."""
    rng = np.random.RandomState(4)
    jvs = JVideoStateNet(FEAT, VH, M, "lstm")
    disc, tx, state = jvgail.make_discriminator(
        jax.random.PRNGKey(3), OBS + VH, jvs, FEAT, T + 2 * M,
        hidden_dims=(16, 12), lr=1e-2)
    state = as_f64(state)
    vs = VideoStateNet(FEAT, VH, M)
    tdisc, opt = tvgail.make_discriminator(OBS + VH, vs, (16, 12), 1e-2,
                                           torch.float64)
    sd_d, sd_vs = discriminator_from_jax(state.discrim, state.discrim_vs)
    tdisc.load_state_dict(sd_d)
    vs.load_state_dict(sd_vs)
    data = dict(windows=rng.randn(B, T + 2 * M, FEAT),
                gen=rng.randn(T, B, OBS) + 0.5,
                expert=rng.randn(T, B, OBS) - 0.5)
    return (disc, tx, state, jvs), (tdisc, vs, opt), data


def _close_sds(nets, want_sds, tol):
    """Each net's state_dict against a state_dict carried from JAX."""
    for net, want in zip(nets, want_sds):
        got = net.state_dict()
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=0, atol=tol, err_msg=key)


def test_discriminator_carries_across(disc_case):
    (_, _, state, _), (tdisc, vs, _), _ = disc_case
    assert [k for k in tdisc.state_dict()] == [
        "net.layers.0.weight", "net.layers.0.bias", "net.layers.1.weight",
        "net.layers.1.bias", "head.weight", "head.bias"]
    _close_sds((tdisc, vs),
               discriminator_from_jax(state.discrim, state.discrim_vs), 0.0)


def test_gail_reward_matches_jax(disc_case):
    (disc, _, state, jvs), (tdisc, vs, _), d = disc_case
    want = jvgail.gail_reward(disc, state, jvs.apply,
                              jnp.asarray(d["windows"]), jnp.asarray(d["gen"]))
    got = tvgail.gail_reward(tdisc, vs, torch.tensor(d["windows"]),
                             torch.tensor(d["gen"]))
    assert got.shape == (T, B) and (got > 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def test_update_discriminator_matches_jax(disc_case):
    (disc, tx, state, jvs), (tdisc, vs, opt), d = disc_case
    jstat, tstat = _stat(OBS, 6)
    new, loss_j = jvgail.update_discriminator(
        disc, tx, state, jvs.apply, jnp.asarray(d["windows"]),
        jnp.asarray(d["gen"]), jnp.asarray(d["expert"]), jstat,
        num_update=3)
    loss_t = tvgail.update_discriminator(
        tdisc, vs, opt, torch.tensor(d["windows"]), torch.tensor(d["gen"]),
        torch.tensor(d["expert"]), tstat, num_update=3)
    assert int(opt.count) == 3
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=0,
                               atol=TOL)
    moved = np.abs(np.asarray(new.discrim["params"]["head"]["kernel"])
                   - np.asarray(state.discrim["params"]["head"]["kernel"]))
    assert moved.max() > 1e-3
    _close_sds((tdisc, vs), discriminator_from_jax(new.discrim,
                                                    new.discrim_vs), TOL)


def test_gather_expert_obs_clamps_like_jax():
    obs = np.random.RandomState(2).randn(N_TAKES, T_TAKE, OBS)
    e, s = np.array([0, 1, 1, 0]), np.array([0, 35, 38, 5])
    want = jvgail.gather_expert_obs(types.SimpleNamespace(
        obs=jnp.asarray(obs)), jnp.asarray(e), jnp.asarray(s), T)
    got = tvgail.gather_expert_obs(types.SimpleNamespace(
        obs=torch.tensor(obs)), torch.tensor(e), torch.tensor(s), T)
    assert got.shape == (T, B, OBS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # past the take's end the window is shifted back inside it
    np.testing.assert_array_equal(got[:, 2].numpy(), obs[1, T_TAKE - T:])


# ---------------------------------------------------------------------------
# AgentVGAIL
# ---------------------------------------------------------------------------

AT, AM, A_TAKE = 6, 3, 40
DISC = {"hidden_dims": [32, 32], "lr": 1e-3, "num_update": 3,
        "reward_weight": 0.7}


@pytest.fixture(scope="module")
def mimic_world():
    """subject_03 at fr_margin 3, 6-step episodes and 2 optimizer epochs,
    with a discriminator block, in both packages; 2 takes x 40 frames of
    expert observations and features."""
    from egopose_tpu.physics.spec import parse_mjcf as jparse
    from egopose_tpu.utils import config as jcfg
    from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
    from egopose_tpu_torch.utils import config as tcfg
    xml = os.path.join(REPO, "assets", "mujoco_models",
                       "humanoid_1205_v1.xml")
    root = os.path.join(REPO, "config")
    jc = jcfg.EgoMimicConfig("subject_03", config_root=root)
    tc = tcfg.EgoMimicConfig("subject_03", config_root=root)
    for c in (jc, tc):
        c.env_episode_len, c.fr_margin, c.num_optim_epoch = AT, AM, 2
        c.discriminator = dict(DISC)
    jspec, tspec = jparse(xml), tparse(xml)
    jp = jcfg.make_env_params(jc, jspec, obs_dim=115, dtype=np.float64)
    tp = tcfg.make_env_params(tc, tspec, obs_dim=115, dtype=torch.float64)
    rng = np.random.RandomState(12)
    cnn = rng.randn(N_TAKES, A_TAKE, 16)
    obs = rng.randn(N_TAKES, A_TAKE, 115) * 0.5
    batch = dict(
        states=rng.randn(AT, B, 115), actions=rng.randn(AT, B, 52) * 0.1,
        rewards=rng.rand(AT, B), masks=(rng.rand(AT, B) > 0.2) * 1.0,
        exps=(rng.rand(AT, B) > 0.3) * 1.0, valids=np.ones((AT, B)),
        reward_info=rng.rand(AT, B, 5), expert_ind=np.array([0, 1, 1, 0]),
        start_ind=np.array([3, 9, 30, 17]), fails=np.zeros((AT, B)))
    return (jc, jspec, jp), (tc, tspec, tp), cnn, obs, batch


def test_agent_vgail_update_matches_jax(mimic_world):
    from egopose_tpu_torch.rl.vgail import AgentVGAIL
    (jc, jspec, jp), (tc, tspec, tp), cnn, obs, batch = mimic_world
    jagent = jvgail.AgentVGAIL(
        None, jspec, jp, None, types.SimpleNamespace(obs=jnp.asarray(obs)),
        jnp.asarray(cnn), jc, batch_lanes=B, seed=1, dtype=jnp.float64)
    jagent.train_state = as_f64(jagent.train_state)
    jagent.vgail_state = as_f64(jagent.vgail_state)
    jagent.zstat = _stat(115, 8)[0]
    tagent = AgentVGAIL(None, tspec, tp, None,
                        types.SimpleNamespace(obs=torch.tensor(obs)), cnn, tc,
                        batch_lanes=B, seed=5, dtype=torch.float64)
    tagent.load_checkpoint(jax.device_get(jagent.checkpoint()))
    vs = jagent.vgail_state
    for net, sd in zip((tagent.discrim_net, tagent.discrim_vs_net),
                       discriminator_from_jax(vs.discrim, vs.discrim_vs)):
        net.load_state_dict(sd)

    m_j = jagent.update_params(
        JSegmentBatch(**{f: jnp.asarray(v) for f, v in batch.items()}))
    m_t = tagent.update_params(
        SegmentBatch(**{f: torch.tensor(v) for f, v in batch.items()}))
    assert set(m_j) <= set(m_t)
    for name in m_j:
        np.testing.assert_allclose(m_t[name], m_j[name], rtol=0,
                                   atol=AGENT_TOL, err_msg=name)
    ts = jagent.train_state
    got = params_to_jax(*[n.state_dict() for n in tagent.nets])
    for g, w in zip(got, (ts.policy, ts.policy_vs, ts.value, ts.value_vs)):
        _close_trees(g, w, AGENT_TOL)
    vs = jagent.vgail_state
    _close_sds((tagent.discrim_net, tagent.discrim_vs_net),
               discriminator_from_jax(vs.discrim, vs.discrim_vs), AGENT_TOL)
    assert int(tagent.discrim_opt.count) == DISC["num_update"]


@pytest.mark.parametrize("weight", [0.0, 1.5])
def test_reward_weight_outside_unit_interval_raises(mimic_world, weight):
    from egopose_tpu_torch.rl.vgail import AgentVGAIL
    _, (tc, tspec, tp), cnn, obs, _ = mimic_world
    cfg = types.SimpleNamespace(**vars(tc))
    cfg.discriminator = dict(DISC, reward_weight=weight)
    with pytest.raises(ValueError, match="reward_weight"):
        AgentVGAIL(None, tspec, tp, None, None, cnn, cfg, batch_lanes=B,
                   dtype=torch.float64)


def test_policy_discrete_matches_jax():
    jpol = JPolicyDiscrete(action_num=5, hidden_dims=(16, 12))
    x = np.random.RandomState(1).randn(7, 10)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        jpol.init(jax.random.PRNGKey(4), jnp.zeros((1, 10))))
    pol = PolicyDiscrete(10, 5, (16, 12)).double()
    pol.load_state_dict(policy_discrete_from_jax(tree))
    with torch.no_grad():
        got = pol(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpol.apply(tree, jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    # the head starts at a tenth of torch's default scale, bias zero
    fresh = PolicyDiscrete(10, 5, (16, 12))
    head = fresh.action_head
    assert float(head.bias.detach().abs().max()) == 0.0
    assert float(head.weight.detach().abs().max()) <= 0.1 / np.sqrt(12)
