"""The port's TRPO and a2c objectives (egopose_tpu_torch/rl/{trpo,ppo}.py)
against the JAX package's, float64 on the CPU, from the same weights
(carried across by convert.py) and the same fixed batch:

- conjugate_gradient on one SPD system to 1e-12;
- the Fisher-vector products: the port's FIM product against its own
  Hessian-of-KL product, and each against the JAX package's (captured from
  its trpo_step), to 1e-9, with and without fix_std;
- trpo_step: the same accepted step fraction (the full step, and a
  backtracked one under a loose KL bound), parameters, kl and
  surrogate_after to 1e-8;
- trpo_update on a tiny SegmentBatch with LSTM context nets: the critic
  and the policy to 1e-8;
- update_value_lbfgs converges in float32, keeps the dtype, and ends
  within 1e-6 of the JAX fit's loss;
- the a2c ppo_update to 1e-9, with and without the kl_target stop;
- one TRPO update of AgentForecast against the JAX forecast agent's on an
  injected batch of the tiny forecast world, to 1e-8;
- an objective the agent does not take raises ValueError at construction.

Parameters are compared as trees: the two packages flatten them in
different orders."""
import copy
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import functional_call

from egopose_tpu.models.video_state_net import VideoStateNet as JVideoStateNet
from egopose_tpu.rl import ppo as jppo, trpo as jtrpo
from egopose_tpu.rl.nets import PolicyGaussian as JPolicy, Value as JValue
from egopose_tpu.rl.rollout import SegmentBatch as JSegmentBatch
from egopose_tpu_torch.convert import (context_from_jax, context_to_jax,
                                       params_from_jax, params_to_jax)
from egopose_tpu_torch.models.video_state_net import VideoStateNet
from egopose_tpu_torch.rl import ppo as tppo, trpo as ttrpo
from egopose_tpu_torch.rl.nets import PolicyGaussian, Value
from egopose_tpu_torch.rl.rollout import SegmentBatch
from test_torch_rl import (ACT, B, FEAT, HID, MARGIN, OBS, T, VH,
                           _assert_same_params, _jax_update, _torch_update,
                           ppo_case)  # noqa: F401  (ppo_case: a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = 1e-12
FVP_TOL = 1e-9
STEP_TOL = 1e-8
A2C_TOL = 1e-9
N, S_OBS, S_ACT, S_HID = 64, 8, 3, (12,)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_f64(tree):
    """A JAX agent's state with every float leaf float64 (flax makes its
    parameters float32 whatever the input's dtype)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64)
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating) else a, tree)


def _close_trees(got, want, tol):
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=0, atol=tol), got, want)


def test_conjugate_gradient_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(12, 12)
    a, b = x @ x.T + 5 * np.eye(12), rng.randn(12)
    want = jtrpo.conjugate_gradient(lambda v: jnp.asarray(a) @ v,
                                    jnp.asarray(b), iters=25)
    at = torch.tensor(a)
    got = ttrpo.conjugate_gradient(lambda v: at @ v, torch.tensor(b), 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=EXACT)
    np.testing.assert_allclose(a @ got.numpy(), b, atol=1e-6)


class _Step:
    """One policy and fixed batch in both packages: JAX's trpo_step run
    with its conjugate_gradient wrapped to keep the Fisher product and the
    CG step direction it solved for."""

    def __init__(self, fix_std=False, seed=3):
        rng = np.random.RandomState(seed)
        self.jpol = JPolicy(S_ACT, S_HID, "tanh", -0.3, fix_std)
        self.tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            self.jpol.init(jax.random.PRNGKey(seed), jnp.zeros((1, S_OBS))))
        self.states = rng.randn(N, S_OBS)
        self.actions = rng.randn(N, S_ACT) * 0.3
        self.adv = rng.randn(N)
        self.exps = (rng.rand(N) > 0.3).astype(np.float64)
        self.pol = PolicyGaussian(S_OBS, S_ACT, S_HID, "tanh", -0.3,
                                  fix_std).double()
        self.pol.load_state_dict(context_from_jax(self.tree))
        self.names = [n for n, _ in self.pol.named_parameters()]
        st = torch.tensor(self.states)
        self.policy_in_fn = lambda prm: functional_call(
            self.pol, dict(zip(self.names, prm)), (st,))
        self.params = tuple(p.detach() for p in self.pol.parameters())

    def jax_step(self, hyper, monkeypatch):
        seen = {}
        real = jtrpo.conjugate_gradient

        def keep(avp, b, iters):
            seen["fvp"] = avp
            seen["stepdir"] = real(avp, b, iters)
            return seen["stepdir"]
        monkeypatch.setattr(jtrpo, "conjugate_gradient", keep)
        x = jnp.asarray(self.states)
        new, info = jtrpo.trpo_step(
            self.tree, lambda p: self.jpol.apply(p, x), x,
            jnp.asarray(self.actions), jnp.asarray(self.adv),
            jnp.asarray(self.exps), hyper)
        return new, info, seen

    def torch_step(self, hyper):
        return ttrpo.trpo_step(
            self.params, self.policy_in_fn, None,
            torch.tensor(self.actions), torch.tensor(self.adv),
            torch.tensor(self.exps), hyper)

    def to_port(self, tree):
        """A JAX-shaped tree (parameters or a tangent) as the port's flat
        vector."""
        sd = context_from_jax(tree)
        return torch.cat([sd[n].reshape(-1) for n in self.names])

    def to_tree(self, flat):
        """The port's flat vector as a JAX-shaped tree."""
        return context_to_jax(dict(zip(
            self.names, ttrpo._unflat(flat, self.params))))

    def tree_of(self, params):
        return context_to_jax(dict(zip(self.names, params)))


@pytest.mark.parametrize("fix_std", [False, True])
def test_fisher_vector_products_match_jax(fix_std, monkeypatch):
    case = _Step(fix_std)
    rng = np.random.RandomState(5)
    v_tree = jax.tree_util.tree_map(lambda a: rng.randn(*np.shape(a)),
                                    case.tree)
    v = case.to_port(v_tree)
    w = torch.tensor(case.exps)
    mine = {use_fim: (ttrpo.fvp_fim if use_fim else ttrpo.fvp_direct)(
        case.policy_in_fn, case.params, w, 1e-3)(v)
        for use_fim in (True, False)}
    np.testing.assert_allclose(mine[True].numpy(), mine[False].numpy(),
                               rtol=0, atol=FVP_TOL)
    assert mine[True].abs().max() > 1.0
    for use_fim in (True, False):
        _, _, seen = case.jax_step(
            jtrpo.TRPOHyper(damping=1e-3, use_fim=use_fim), monkeypatch)
        want = jtrpo._unflat(seen["fvp"](jtrpo._flat(v_tree)), case.tree)
        _close_trees(case.to_tree(mine[use_fim]), want, FVP_TOL)


@pytest.mark.parametrize("max_kl", [1e-2, 5.0])
def test_trpo_step_matches_jax(max_kl, monkeypatch):
    case = _Step()
    hyper = jtrpo.TRPOHyper(max_kl=max_kl)
    want, info_j, seen = case.jax_step(hyper, monkeypatch)
    got, info_t = case.torch_step(ttrpo.TRPOHyper(max_kl=max_kl))
    assert bool(info_t["ls_success"]) == bool(info_j["ls_success"]) is True
    # the JAX step's fraction of its full step
    stepdir = np.asarray(seen["stepdir"])
    shs = 0.5 * stepdir @ np.asarray(seen["fvp"](seen["stepdir"]))
    full = stepdir / np.sqrt(shs / max_kl)
    moved = np.asarray(jtrpo._flat(want) - jtrpo._flat(case.tree))
    frac = float(moved @ full / (full @ full))
    np.testing.assert_allclose(float(info_t["step_frac"]), frac, rtol=1e-9)
    assert float(info_t["step_frac"]) == (1.0 if max_kl < 1 else 0.5 ** round(
        -np.log2(frac)))
    if max_kl > 1:
        assert float(info_t["step_frac"]) < 1.0     # the search backtracked
    _close_trees(case.tree_of(got), want, STEP_TOL)
    for key in ("kl", "surrogate_after", "surrogate_loss"):
        np.testing.assert_allclose(float(info_t[key]), float(info_j[key]),
                                   rtol=0, atol=STEP_TOL, err_msg=key)
    assert 0 < float(info_t["kl"]) <= 1.5 * max_kl
    assert float(info_t["surrogate_after"]) < float(info_t["surrogate_loss"])


def _trees(seed):
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    win = jnp.zeros((1, T + 2 * MARGIN, FEAT))
    vs = JVideoStateNet(FEAT, VH, MARGIN, "lstm")
    x0 = jnp.zeros((1, OBS + VH))
    f64 = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), t)
    return [f64(JPolicy(ACT, HID, "relu", -1.0).init(k[0], x0)),
            f64(vs.init(k[1], win)), f64(JValue(HID, "relu").init(k[2], x0)),
            f64(vs.init(k[3], win))]


def test_trpo_update_matches_jax(ppo_case):
    trees, batch, windows = ppo_case
    jpol, jval = JPolicy(ACT, HID, "relu", -1.0), JValue(HID, "relu")
    jvs = JVideoStateNet(FEAT, VH, MARGIN, "lstm")

    def ctx(p_vs, win, states):
        return jnp.concatenate(
            [jvs.apply(p_vs, win).transpose(1, 0, 2), states], -1)

    opt_kw = dict(policy_lr=3e-3, value_lr=1e-2)
    hyper = jppo.PPOHyper(num_epochs=2)
    t_hyper = jtrpo.TRPOHyper(max_kl=1e-2)
    opt_p, opt_v = jppo.make_optimizers(**opt_kw)
    ts_j = jppo.TrainState(
        policy=trees[0], policy_vs=trees[1], value=trees[2],
        value_vs=trees[3], opt_policy=opt_p.init((trees[0], trees[1])),
        opt_value=opt_v.init((trees[2], trees[3])))
    jb = JSegmentBatch(**{f: jnp.asarray(v) for f, v in batch.items()})
    ts_j, m_j = jax.jit(lambda ts, b, w: jtrpo.trpo_update(
        ts, opt_v, hyper, t_hyper, b, w, jpol.apply, ctx, jval.apply,
        ctx))(ts_j, jb, jnp.asarray(windows))

    nets = [PolicyGaussian(OBS + VH, ACT, HID, "relu", -1.0),
            VideoStateNet(FEAT, VH, MARGIN), Value(OBS + VH, HID, "relu"),
            VideoStateNet(FEAT, VH, MARGIN)]
    for net, sd in zip(nets, params_from_jax(*trees)):
        net.double().load_state_dict(sd)
    opt_tp, opt_tv = tppo.make_optimizers(
        [*nets[0].parameters(), *nets[1].parameters()],
        [*nets[2].parameters(), *nets[3].parameters()], **opt_kw)
    ts_t = tppo.TrainState(*nets, opt_policy=opt_tp, opt_value=opt_tv)
    tb = SegmentBatch(**{f: torch.tensor(v) for f, v in batch.items()})
    _, m_t = ttrpo.trpo_update(ts_t, tppo.PPOHyper(num_epochs=2),
                               ttrpo.TRPOHyper(max_kl=1e-2), tb,
                               torch.tensor(windows))

    assert float(m_t["ls_success"]) == float(m_j["ls_success"]) == 1.0
    moved = np.abs(np.asarray(ts_j.policy_vs["params"]["v_net"]["rnn_f"]
                              ["ih"]["kernel"])
                   - trees[1]["params"]["v_net"]["rnn_f"]["ih"]["kernel"])
    assert moved.max() > 1e-6          # the natural step moved the context
    _assert_same_params(ts_t, ts_j, STEP_TOL)
    assert set(m_t) == set(m_j)
    for name in m_j:
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]),
                                   rtol=0, atol=STEP_TOL, err_msg=name)
    # the policy optimizer's state is untouched, the value one took 2 steps
    assert int(opt_tp.count) == 0 and int(opt_tv.count) == 2


def test_update_value_lbfgs_matches_jax():
    rng = np.random.RandomState(3)
    target = {"w": rng.randn(6, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    loss_j = lambda p: sum(jnp.sum((p[k] - target[k]) ** 2) for k in p)
    fit_j = jtrpo.update_value_lbfgs(
        loss_j, {"w": jnp.zeros((6, 4), jnp.float32),
                 "b": jnp.zeros(4, jnp.float32)})
    tt = [torch.tensor(target["w"]), torch.tensor(target["b"])]
    loss_t = lambda p: sum(torch.sum((a - b) ** 2) for a, b in zip(p, tt))
    fit_t = ttrpo.update_value_lbfgs(
        loss_t, [torch.zeros(6, 4, dtype=torch.float32),
                 torch.zeros(4, dtype=torch.float32)])
    assert all(p.dtype == torch.float32 for p in fit_t)
    for got, key in zip(fit_t, ("w", "b")):
        np.testing.assert_allclose(got.numpy(), target[key], atol=1e-4)
    assert abs(float(loss_t(fit_t)) - float(loss_j(fit_j))) <= 1e-6


@pytest.mark.parametrize("kl_target", [0.0, 1e-8])
def test_a2c_update_matches_jax(ppo_case, kl_target):
    trees, batch, windows = ppo_case
    opt_kw = dict(policy_lr=3e-3, value_lr=1e-2)
    ts_j, m_j = _jax_update(
        trees, batch, windows,
        jppo.PPOHyper(num_epochs=3, kl_target=kl_target), opt_kw,
        objective="a2c")
    ts_t, m_t = _torch_update(
        trees, batch, windows,
        tppo.PPOHyper(num_epochs=3, kl_target=kl_target), opt_kw,
        objective="a2c")
    _assert_same_params(ts_t, ts_j, A2C_TOL)
    for name in ("policy_loss", "value_loss"):
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]),
                                   rtol=0, atol=A2C_TOL, err_msg=name)
    # the a2c loss is not PPO's: the same batch moves PPO elsewhere
    ts_p, _ = _torch_update(trees, batch, windows,
                            tppo.PPOHyper(num_epochs=3), opt_kw)
    a2c_bias = ts_t.policy.action_mean.bias.detach()
    assert (a2c_bias - ts_p.policy.action_mean.bias.detach()).abs().max() \
        > 1e-6
    if kl_target:
        assert bool(m_t["kl_stopped"]) and bool(m_j["kl_stopped"])
        assert int(ts_t.opt_policy.count) == 1


# ---------------------------------------------------------------------------
# the agents: objective chosen at construction, the forecast agent's TRPO
# ---------------------------------------------------------------------------

FB, FT, FM, FEAT_F = 4, 6, 5, 16


@pytest.fixture(scope="module")
def forecast_world():
    """The forecast config at fr_margin 5, 2 optimizer epochs and TRPO, in
    both packages, and one injected batch over 2 takes x 40 frames of
    features."""
    from egopose_tpu.physics.spec import parse_mjcf as jparse
    from egopose_tpu.utils import config as jcfg
    from egopose_tpu_torch.physics.spec import parse_mjcf as tparse
    from egopose_tpu_torch.utils import config as tcfg
    xml = os.path.join(REPO, "assets", "mujoco_models",
                       "humanoid_1205_v1.xml")
    root = os.path.join(REPO, "config")
    jc = jcfg.EgoForecastConfig("subject_03_syn", config_root=root)
    tc = tcfg.EgoForecastConfig("subject_03_syn", config_root=root)
    for c in (jc, tc):
        c.env_episode_len, c.fr_margin, c.num_optim_epoch = FT, FM, 2
        c.policy_objective = "trpo"
    jspec, tspec = jparse(xml), tparse(xml)
    jp = jcfg.make_env_params(jc, jspec, obs_dim=115, dtype=np.float64)
    tp = tcfg.make_env_params(tc, tspec, obs_dim=115, dtype=torch.float64)
    rng = np.random.RandomState(11)
    cnn = rng.randn(2, 40, FEAT_F)
    batch = dict(
        states=rng.randn(FT, FB, 115), actions=rng.randn(FT, FB, 52) * 0.1,
        rewards=rng.rand(FT, FB), masks=(rng.rand(FT, FB) > 0.2) * 1.0,
        exps=(rng.rand(FT, FB) > 0.3) * 1.0, valids=np.ones((FT, FB)),
        reward_info=rng.rand(FT, FB, 5), expert_ind=np.array([0, 1, 1, 0]),
        start_ind=np.array([5, 9, 30, 17]), fails=np.zeros((FT, FB)))
    return (jc, jspec, jp), (tc, tspec, tp), cnn, batch


def test_forecast_agent_trpo_matches_jax(forecast_world):
    from egopose_tpu.rl import agent_forecast as jaf
    from egopose_tpu_torch.rl.agent_forecast import AgentForecast
    (jc, jspec, jp), (tc, tspec, tp), cnn, batch = forecast_world
    jagent = jaf.make_forecast_agent(None, jspec, jp, None, None,
                                     jnp.asarray(cnn), jc, batch_lanes=FB,
                                     seed=2, dtype=jnp.float64)
    tagent = AgentForecast(None, tspec, tp, None, None, cnn, tc,
                           batch_lanes=FB, seed=7, dtype=torch.float64)
    assert jagent.objective == tagent.objective == "trpo"
    jagent.train_state = as_f64(jagent.train_state)
    tagent.load_checkpoint(jax.device_get(jagent.checkpoint()))
    m_j = jagent.update_params(
        JSegmentBatch(**{f: jnp.asarray(v) for f, v in batch.items()}))
    m_t = tagent.update_params(
        SegmentBatch(**{f: torch.tensor(v) for f, v in batch.items()}))
    assert m_t["ls_success"] == m_j["ls_success"] == 1.0
    assert 0 < m_t["kl"] <= 1.5 * tc.max_kl
    ts = jagent.train_state
    got = params_to_jax(*[n.state_dict() for n in tagent.nets])
    for g, w in zip(got, (ts.policy, ts.policy_vs, ts.value, ts.value_vs)):
        _close_trees(g, w, STEP_TOL)
    for name in m_j:
        np.testing.assert_allclose(m_t[name], m_j[name], rtol=0,
                                   atol=STEP_TOL, err_msg=name)


@pytest.mark.parametrize("objective", ["a2c", "trpo", "ddpg"])
def test_objective_chosen_at_construction(forecast_world, objective):
    from egopose_tpu_torch.rl.agent_forecast import AgentForecast
    _, (tc, tspec, tp), cnn, _ = forecast_world
    cfg = copy.copy(tc)
    cfg.policy_objective = objective
    make = lambda: AgentForecast(None, tspec, tp, None, None, cnn, cfg,
                                 batch_lanes=2, dtype=torch.float64)
    if objective == "ddpg":
        with pytest.raises(ValueError, match="policy_objective"):
            make()
        return
    agent = make()
    assert agent.objective == objective
    assert (agent.trpo_hyper is None) == (objective != "trpo")
