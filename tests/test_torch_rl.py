"""The PPO pieces of egopose_tpu_torch against the JAX package, float64 on
the CPU: GAE, the diagonal-Gaussian log density and the ZFilter's Chan
merge to 1e-12 (same arithmetic, summed in another order), and ppo_update
on one fixed SegmentBatch (T=6, B=4, small nets) from the same starting
weights (carried across by params_from_jax): all four nets' parameters and
both losses agree to 1e-9 after two epochs, full-batch (with the global-norm
clip active and AdamW) and on JAX's minibatch permutations; a NaN reward
skips every update and counts the skips as optax.apply_if_finite does; the
kl_target stop trips where JAX's does."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from egopose_tpu.models.video_state_net import VideoStateNet as JVideoStateNet
from egopose_tpu.ops import gae as jgae, running_norm as jrn
from egopose_tpu.rl import distributions as jdist, ppo as jppo
from egopose_tpu.rl.nets import PolicyGaussian as JPolicy, Value as JValue
from egopose_tpu.rl.rollout import SegmentBatch as JSegmentBatch
from egopose_tpu_torch.convert import params_from_jax, params_to_jax
from egopose_tpu_torch.models.video_state_net import VideoStateNet
from egopose_tpu_torch.ops import gae as tgae, running_norm as trn
from egopose_tpu_torch.rl import distributions as tdist, ppo as tppo
from egopose_tpu_torch.rl.nets import PolicyGaussian, Value
from egopose_tpu_torch.rl.rollout import SegmentBatch

EXACT = 1e-12    # same formula, another summation order
PPO_TOL = 1e-9   # two epochs of Adam through LSTM + MLP gradients
T, B, OBS, ACT, FEAT, VH, MARGIN, HID = 6, 4, 9, 5, 6, 8, 2, (16, 12)


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol,
                               err_msg=what)


def test_gae_matches_jax():
    rng = np.random.RandomState(0)
    r, v = rng.randn(7, 3), rng.randn(7, 3)
    m = (rng.rand(7, 3) > 0.2).astype(float)
    valid = (rng.rand(7, 3) > 0.3).astype(float)
    for vd in (None, valid):
        a_j, ret_j = jgae.estimate_advantages(
            jnp.asarray(r), jnp.asarray(m), jnp.asarray(v), 0.95, 0.9,
            valid=None if vd is None else jnp.asarray(vd))
        a_t, ret_t = tgae.estimate_advantages(
            torch.tensor(r), torch.tensor(m), torch.tensor(v), 0.95, 0.9,
            valid=None if vd is None else torch.tensor(vd))
        _close(a_t, a_j, EXACT, "advantages")
        _close(ret_t, ret_j, EXACT, "returns")


def test_log_prob_and_push_batch_match_jax():
    rng = np.random.RandomState(1)
    x, mean, log_std = rng.randn(3, 4, 5), rng.randn(3, 4, 5), \
        rng.randn(5) * 0.3
    _close(tdist.diag_gaussian_log_prob(torch.tensor(x), torch.tensor(mean),
                                        torch.tensor(log_std)),
           jdist.diag_gaussian_log_prob(jnp.asarray(x), jnp.asarray(mean),
                                        jnp.asarray(log_std)), EXACT)
    noise = rng.randn(4, 5)
    _close(tdist.diag_gaussian_sample(torch.tensor(mean[0]),
                                      torch.tensor(log_std),
                                      noise=torch.tensor(noise)),
           mean[0] + np.exp(log_std) * noise, EXACT)
    js, ts = jrn.init_stat(6, jnp.float64), trn.init_stat(6, torch.float64)
    batches = [(rng.randn(5, 6) * 3 + 1, None),
               (rng.randn(2, 3, 6), rng.rand(2, 3)),
               (rng.randn(4, 6), np.zeros(4))]          # empty: no change
    for xb, w in batches:
        js = jrn.push_batch(js, jnp.asarray(xb),
                            None if w is None else jnp.asarray(w))
        ts = trn.push_batch(ts, torch.tensor(xb),
                            None if w is None else torch.tensor(w))
        for name in ("n", "mean", "s"):
            _close(getattr(ts, name), getattr(js, name), EXACT, name)
    assert float(ts.n) == 5 + np.sum(batches[1][1])


@pytest.fixture(scope="module")
def ppo_case():
    """Small nets' flax trees (float64) and one SegmentBatch with episode
    ends, non-exploration rows and an invalid row."""
    k = jax.random.split(jax.random.PRNGKey(3), 4)
    win = jnp.zeros((1, T + 2 * MARGIN, FEAT))
    vs = JVideoStateNet(FEAT, VH, MARGIN, "lstm")
    x0 = jnp.zeros((1, OBS + VH))
    f64 = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), t)
    trees = [f64(JPolicy(ACT, HID, "relu", -1.0).init(k[0], x0)),
             f64(vs.init(k[1], win)), f64(JValue(HID, "relu").init(k[2], x0)),
             f64(vs.init(k[3], win))]
    rng = np.random.RandomState(4)
    batch = dict(
        states=rng.randn(T, B, OBS), actions=rng.randn(T, B, ACT) * 0.4,
        rewards=rng.rand(T, B), masks=(rng.rand(T, B) > 0.15).astype(float),
        exps=(rng.rand(T, B) > 0.25).astype(float), valids=np.ones((T, B)),
        reward_info=rng.rand(T, B, 5), expert_ind=np.zeros(B, np.int64),
        start_ind=np.zeros(B, np.int64), fails=np.zeros((T, B)))
    batch["valids"][2, 3] = 0.0
    windows = rng.randn(B, T + 2 * MARGIN, FEAT)
    return trees, batch, windows


def _jax_update(trees, batch, windows, hyper, opt_kw, key=None, mb=0,
                objective="ppo"):
    jpol, jval = JPolicy(ACT, HID, "relu", -1.0), JValue(HID, "relu")
    jvs = JVideoStateNet(FEAT, VH, MARGIN, "lstm")

    def ctx(p_vs, win, states):
        return jnp.concatenate(
            [jvs.apply(p_vs, win).transpose(1, 0, 2), states], -1)

    opt_p, opt_v = jppo.make_optimizers(**opt_kw)
    ts = jppo.TrainState(
        policy=trees[0], policy_vs=trees[1], value=trees[2],
        value_vs=trees[3], opt_policy=opt_p.init((trees[0], trees[1])),
        opt_value=opt_v.init((trees[2], trees[3])))
    jb = JSegmentBatch(**{f: jnp.asarray(v) for f, v in batch.items()})
    ts, metrics = jax.jit(lambda ts, b, w, kk: jppo.ppo_update(
        ts, opt_p, opt_v, hyper, b, w, jpol.apply, ctx, jval.apply, ctx,
        key=kk, mini_batch_lanes=mb, objective=objective))(
        ts, jb, jnp.asarray(windows), key)
    return ts, metrics


def _torch_update(trees, batch, windows, hyper, opt_kw, perms=None, mb=0,
                  objective="ppo"):
    sds = params_from_jax(*trees)
    nets = [PolicyGaussian(OBS + VH, ACT, HID, "relu", -1.0),
            VideoStateNet(FEAT, VH, MARGIN), Value(OBS + VH, HID, "relu"),
            VideoStateNet(FEAT, VH, MARGIN)]
    for net, sd in zip(nets, sds):
        net.double().load_state_dict(sd)
    opt_p, opt_v = tppo.make_optimizers(
        [*nets[0].parameters(), *nets[1].parameters()],
        [*nets[2].parameters(), *nets[3].parameters()], **opt_kw)
    ts = tppo.TrainState(*nets, opt_policy=opt_p, opt_value=opt_v)
    tb = SegmentBatch(**{f: torch.tensor(v) for f, v in batch.items()})
    return tppo.ppo_update(ts, hyper, tb, torch.tensor(windows),
                           mini_batch_lanes=mb, perms=perms,
                           objective=objective)


def _assert_same_params(ts_t, ts_j, tol):
    got = params_to_jax(*[n.state_dict() for n in ts_t[:4]])
    for g, w in zip(got, ts_j[:4]):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                    rtol=0, atol=tol), g, w)


@pytest.mark.parametrize("mode", ["full_batch", "minibatch"])
def test_ppo_update_matches_jax(ppo_case, mode):
    trees, batch, windows = ppo_case
    hyper = jppo.PPOHyper(num_epochs=2)
    lrs = dict(policy_lr=3e-3, value_lr=1e-2)
    if mode == "full_batch":
        # a small clip makes the global-norm clip act on every step; the
        # policy optimizer is AdamW
        opt_kw = dict(lrs, grad_clip=0.05, policy_weight_decay=0.01)
        ts_j, m_j = _jax_update(trees, batch, windows, hyper, opt_kw)
        ts_t, m_t = _torch_update(trees, batch, windows,
                                  tppo.PPOHyper(num_epochs=2), opt_kw)
    else:
        opt_kw = dict(lrs, grad_clip=40.0)
        key = jax.random.PRNGKey(5)
        perms = np.stack([np.asarray(jax.random.permutation(ke, B))
                          for ke in jax.random.split(key, 2)])
        ts_j, m_j = _jax_update(trees, batch, windows, hyper, opt_kw,
                                key=key, mb=2)
        ts_t, m_t = _torch_update(trees, batch, windows,
                                  tppo.PPOHyper(num_epochs=2), opt_kw,
                                  perms=perms, mb=2)
    moved = np.abs(np.asarray(ts_j.policy["params"]["action_mean"]["bias"])
                   - trees[0]["params"]["action_mean"]["bias"]).max()
    assert moved > 1e-4                       # the update did something
    _assert_same_params(ts_t, ts_j, PPO_TOL)
    for name in ("policy_loss", "value_loss", "n_valid", "n_exp"):
        _close(m_t[name], m_j[name], PPO_TOL, name)


def test_ppo_nan_reward_skips_like_jax(ppo_case):
    trees, batch, windows = ppo_case
    batch = dict(batch, rewards=batch["rewards"].copy())
    batch["rewards"][2, 1] = np.nan
    opt_kw = dict(policy_lr=3e-3, value_lr=1e-2)
    ts_j, _ = _jax_update(trees, batch, windows, jppo.PPOHyper(num_epochs=2),
                          opt_kw)
    ts_t, _ = _torch_update(trees, batch, windows,
                            tppo.PPOHyper(num_epochs=2), opt_kw)
    for name in ("policy", "value"):
        want = ts_j._asdict()["opt_" + name].inner_state.total_notfinite
        got = getattr(ts_t, "opt_" + name).total_notfinite
        assert int(got) == int(want) == 2, name
    _assert_same_params(ts_t, ts_j, 0.0)
    _assert_same_params(ts_t, trees, 0.0)     # nothing moved


def test_ppo_kl_stop_matches_jax(ppo_case):
    trees, batch, windows = ppo_case
    opt_kw = dict(policy_lr=3e-3, value_lr=1e-2)
    ts_j, m_j = _jax_update(trees, batch, windows,
                            jppo.PPOHyper(num_epochs=3, kl_target=1e-8),
                            opt_kw)
    ts_t, m_t = _torch_update(trees, batch, windows,
                              tppo.PPOHyper(num_epochs=3, kl_target=1e-8),
                              opt_kw)
    assert bool(m_t["kl_stopped"]) and bool(m_j["kl_stopped"])
    _assert_same_params(ts_t, ts_j, PPO_TOL)
    # the stop tripped after the first policy step: one committed update
    assert int(ts_t.opt_policy.count) == 1
    assert int(ts_t.opt_value.count) == 3
