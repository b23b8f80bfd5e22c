"""The training cells' comparison.

The set-up's first iterations (``check_iters`` of them: sample, then
update) run through the program's own training loop, on the object that
the window then goes on with.  The reference follows them, in float64,
from the benchmark's own inputs (the configuration, the seed, the
committed checkpoint file), and from the program's own state where a
chaotic rollout leaves no other way (PERF.md says so):

- the random numbers of each segment, drawn again from the seed:
  ``draw_mismatch`` counts lanes whose reset take or start frame differ;
- the initial weights, made again from the seed (and the ego-mimic
  checkpoint for the forecast's warm start): ``init_mismatch`` counts
  leaves that differ, bit for bit;
- for a sample of lanes drawn from the seed, every control step from the
  program's state before it: the observation (``obs_gap``), the
  running-norm filter worked out again over every lane's pushes
  (``zobs_gap``, over the columns that carry more than rounding noise:
  eval_check.NOISE_STD), the policy's mean action from those filtered
  observations and the initial weights, plus the drawn noise where the
  gate explored (``action_gap``, the first iteration: after an update
  the two sides' weights differ by the update's rounding),
  the control step (split path, the plain version of K1) and the reward
  from the program's action (``qpos_gap``, ``qvel_gap``, ``reward_gap``;
  the next state too, re-anchored where the lane fell), the fall flag
  away from its threshold (``flag_mismatch``);
- the PPO update on the program's batch, from the reference's own
  weights: each iteration's losses (``loss_gap``), the first gradient of
  each optimizer as it gets it (``grad_gap``, by the worst leaf: the gap
  of the leaf norms over the larger of the reference's leaf norm and the
  median leaf's), and the change of the weights over the iterations
  (``change_gap``, the same measure, leaving out leaves whose reference
  gradient is under a thousandth of the median leaf's).

The window's last iteration is followed the same way (``iters`` marks it
``window``; the window's other iterations, marked ``skip``, only carry
the draws and the filter's pushes on), from the weights and optimizer
state the program had before it: its actions, physics, flags and losses
count in the numbers above, and the change of the weights in its one
update in ``change_gap``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import world as W
from .eval_check import FIELDS, NOISE_STD, gap, spread_gap
from .plain import envs as E
from .plain.ops import running_norm
from .plain.physics import engine

SAMPLE_LANES = 64
FLAG_MARGIN = 1e-6      # metres of head height a fall flag may flip by


def leaf_gap(got: list, want: list, keep=None) -> float:
    """The worst leaf: |‖got‖ - ‖want‖| over max(‖want‖, median ‖want‖)."""
    g = torch.stack([x.double().norm().cpu() for x in got])
    w = torch.stack([x.double().norm().cpu() for x in want])
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    med = torch.median(w)
    rel = (g - w).abs() / torch.maximum(w, med).clamp(min=1e-300)
    if keep is not None:
        rel = rel[keep]
    return float(rel.max())


class Ref:
    """The reference of a training cell in one precision."""

    def __init__(self, kind, cfg, n_takes, t_len, ckpt, lanes, dtype,
                 device):
        self.kind, self.cfg, self.dtype, self.device = kind, cfg, dtype, \
            device
        self.w = W.build_world(cfg, n_takes, t_len, dtype, device)
        p = self.w.p
        self.nets = W.make_nets(kind, cfg, p.obs_dim, p.nu, cfg.seed,
                                dtype, device)
        if kind == "egoforecast":
            W.warm_start(self.nets, ckpt)
        self.opts = W.make_adams(self.nets, cfg)
        self.init = [x.detach().clone() for x in self.leaves()]

    def leaves(self):
        return list(W.leaves(self.nets).values())

    def state(self, s):
        cast = lambda x: x.to(self.device, self.dtype) \
            if x.is_floating_point() else x.to(self.device)
        return E.EnvState(*[cast(s[f]) for f in FIELDS])

    @torch.no_grad()
    def means(self, it, lanes, zobs):
        """The policy's mean actions at every step of iteration ``it``'s
        recorded lanes, (T, L, nu), from filtered observations ``zobs``
        and the reference's weights."""
        p, zobs = self.w.p, zobs.to(self.device, self.dtype)
        win = W.windows_of(self.kind, self.w.cnn_feat,
                           it["expert_ind"][lanes].to(self.device),
                           it["start_ind"][lanes].to(self.device),
                           p.fr_margin, p.env_episode_len)
        vs, pol = self.nets.policy_vs, self.nets.policy
        if self.kind == "egoforecast":
            v = vs.encode_video(win)
            fresh = vs.s_init_carry((len(lanes),), zobs[0])
            carry, out = fresh, []
            fails = it["fails"][:, lanes].to(self.device) > 0
            for t in range(zobs.shape[0]):
                carry, s_out = vs.s_step(carry, zobs[t])
                out.append(pol(torch.cat([v, s_out], -1))[0])
                carry = tuple(torch.where(fails[t][:, None], a, b)
                              for a, b in zip(fresh, carry))
            return torch.stack(out)
        ctx = vs(win).transpose(0, 1)
        return pol(torch.cat([ctx, zobs], -1))[0]

    @torch.no_grad()
    def step(self, st, action, end_reward):
        return E.step(self.w.model, self.w.p, self.w.tables, self.w.expert,
                      st, action.to(self.device, self.dtype), end_reward)

    def reanchor(self, expert_ind, start_ind, cur_t, anchor_noise):
        """The rollout's re-anchor of a fallen lane after its step."""
        p, ex = self.w.p, self.w.expert
        if p.random_cur_t:
            cur_t = torch.where(cur_t >= p.env_episode_len,
                                torch.zeros_like(cur_t), cur_t)
        ind = start_ind + cur_t
        qpos = ex.qpos[expert_ind, ind].clone()
        qpos[:, 7:] += p.env_init_noise * anchor_noise.to(self.dtype)
        return qpos, ex.qvel[expert_ind, ind]

    def filter_chain(self, pushes, stat=None):
        """The running-norm statistics after each push, from zero."""
        p = self.w.p
        stat = stat or running_norm.init_stat(p.obs_dim, self.dtype,
                                              self.device)
        out = []
        for x in pushes:
            stat = running_norm.push_batch(stat, x.to(self.device,
                                                      self.dtype))
            out.append(stat)
        return out

    @torch.no_grad()
    def load(self, params, adam):
        """Take the weights and the optimizers' state the program had."""
        for dst, src in zip(self.leaves(), params):
            dst.copy_(src.to(self.device, self.dtype))
        for opt, st in zip(self.opts, adam):
            cast = lambda xs: [x.to(self.device, self.dtype) for x in xs]
            opt.mu, opt.nu, opt.count = cast(st["mu"]), cast(st["nu"]), \
                int(st["count"])
            opt.first_grad = None

    def first_grads(self):
        return self.opts[0].first_grad + self.opts[1].first_grad

    def update(self, it, end_lr):
        p = self.w.p
        W.fill_log_std(self.nets, self.cfg.log_std)
        self.opts[0].lr = end_lr
        batch = {k: it[k].to(self.device, self.dtype)
                 for k in ("states", "actions", "rewards", "masks", "exps",
                           "valids")}
        win = W.windows_of(self.kind, self.w.cnn_feat,
                           it["expert_ind"].to(self.device),
                           it["start_ind"].to(self.device),
                           p.fr_margin, p.env_episode_len)
        return W.ppo_update(self.nets, self.opts, self.cfg, batch, win)


def check(kind, cfg, n_takes, t_len, ckpt, lanes, iters, prog, device,
          control=False) -> dict:
    """The numbers of a training cell.  ``iters``: per checked iteration a
    dict of CPU tensors -- the batch (``states``, ``actions``, ``rewards``,
    ``masks``, ``exps``, ``valids``, ``fails``, ``expert_ind``,
    ``start_ind``), the state before every step at the sampled lanes
    (``s_`` + each of FIELDS, (T, L, ...)), the state after the physics (``after_*``), the
    reward and fall flag, every push of the filter (``pushes``, full
    lanes) and ``end_reward``.  ``prog``: the program's weights before the
    first update and after the last (lists in the reference's leaf order),
    its first gradient of each optimizer, each checked iteration's
    (policy loss, value loss), and under ``window`` the weights and the
    optimizers' state (``mu``, ``nu``, ``count``) before the window's last
    update and the weights after it.  With ``control`` the reference in
    float32 with TF32 on stands in the program's place."""
    ref = Ref(kind, cfg, n_takes, t_len, ckpt, lanes, torch.float64, device)
    p = ref.w.p
    out = {}
    gen_dev = torch.device(prog["noise_device"])
    gen = torch.Generator(device=gen_dev)
    gen.manual_seed(int(cfg.seed))
    sample = torch.as_tensor(np.sort(np.random.RandomState(
        cfg.seed).choice(lanes, min(SAMPLE_LANES, lanes), replace=False)))
    # weights at the start: exact
    ref_init = ref.init
    out["init_mismatch"] = sum(
        int(not torch.equal(a.float().cpu(), b.float().cpu()))
        for a, b in zip(prog["params_before"], ref_init))
    side = Ref(kind, cfg, n_takes, t_len, ckpt, lanes, torch.float32,
               device) if control else None
    gaps = {k: 0.0 for k in ("obs_gap", "zobs_gap", "action_gap",
                             "qpos_gap", "qvel_gap", "reward_gap",
                             "qpos_max", "qvel_max", "reward_max",
                             "next_gap", "loss_gap", "window_change_gap")}
    flags = draws = 0
    stat_r = stat_s = None
    unchanged, ref_losses = {}, []
    losses = iter(prog["losses"])
    warm = [it for it in iters if not it.get("skip") and
            not it.get("window")]
    for k, it in enumerate(iters):
        noise = W.draw_noise(p, ref.w.expert.lens, ref.w.expert.qpos.shape[0],
                             lanes, 1.0, gen, prog["noise_dtype"])
        if it.get("skip"):
            # an iteration of the window that is not checked: its draws
            # and the filter's pushes carry on to the next
            stat_r = ref.filter_chain(it["pushes"], stat_r)[-1]
            if control:
                with tf32():
                    stat_s = side.filter_chain(it["pushes"], stat_s)[-1]
            continue
        if it.get("window"):
            # the window's last iteration, from the weights and optimizer
            # state the program had before it
            win = prog["window"]
            for r in (ref, side) if control else (ref,):
                r.load(win["params_before"], win["adam"])
        draws += int((noise.expert_ind.cpu() != it["expert_ind"]).sum()
                     + (noise.start_ind.cpu() != it["start_ind"]).sum())
        L = sample
        st_in = {f: it["s_" + f] for f in FIELDS}             # (T, Ls, ...)
        T = it["states"].shape[0]
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        st = ref.state({f: flat(v) for f, v in st_in.items()})
        # observation and filter
        chain = ref.filter_chain(it["pushes"], stat_r)
        stat_r = chain[-1]
        obs_ref = E.observe(p, st).reshape(T, len(L), -1)
        zobs_ref = torch.stack([running_norm.apply(chain[t], obs_ref[t],
                                                   clip=5.0)
                                for t in range(T)])
        if control:
            st_s = side.state({f: flat(v) for f, v in st_in.items()})
            with tf32():
                chain_s = side.filter_chain(it["pushes"], stat_s)
            stat_s = chain_s[-1]
            obs = E.observe(side.w.p, st_s).reshape(T, len(L), -1)
            zobs = torch.stack([running_norm.apply(chain_s[t], obs[t],
                                                   clip=5.0)
                                for t in range(T)])
        else:
            obs = torch.stack([x[L] for x in it["pushes"][:T]])
            zobs = it["states"][:, L]
        gaps["obs_gap"] = max(gaps["obs_gap"], gap(flat(obs), flat(obs_ref)))
        signal = torch.stack([running_norm.std(chain[t]) >= NOISE_STD
                              for t in range(T)])[:, None, :].expand_as(
                                  zobs_ref)
        gaps["zobs_gap"] = max(gaps["zobs_gap"], gap(
            zobs.to(device)[signal], zobs_ref[signal]))
        # actions: mean, plus the drawn noise where the gate explored; the
        # policy sees the reference's filtered observations, and each
        # side's own values in the columns of rounding noise
        noise_cols = ~signal
        mean = ref.means(it, L, torch.where(noise_cols, zobs.to(device),
                                            zobs_ref))
        log_std = ref.nets.policy.action_log_std.detach()
        gate = noise.gate[:, L.to(gen_dev)].to(device)[..., None]
        drawn = noise.act_noise[:, L.to(gen_dev)].to(device, torch.float64)
        want = torch.where(gate, mean + torch.exp(log_std) * drawn, mean)
        if control:
            with tf32():
                m_s = side.means(it, L, zobs)
            got = torch.where(gate, m_s + torch.exp(
                side.nets.policy.action_log_std.detach()) * drawn.float(),
                m_s)
        else:
            got = it["actions"][:, L]
        if k == 0 or it.get("window"):   # the sides' weights agree
            gaps["action_gap"] = max(gaps["action_gap"],
                                     gap(flat(got), flat(want)))
        # the control step, the reward, the fall flag, the next state
        act = flat(got.to(device) if control else it["actions"][:, L])
        new_r, out_r = ref.step(st, act, it["end_reward"])
        if control:
            with tf32():
                new_s, out_s = side.step(st_s, act.float(),
                                            it["end_reward"])
            a_q, a_v, rew, fail = new_s.qpos, new_s.qvel, out_s.reward, \
                out_s.fail
        else:
            a_q, a_v = flat(it["after_qpos"]), flat(it["after_qvel"])
            rew, fail = flat(it["reward"]), flat(it["fail"])
        for key, got_x, want_x, base in (
                ("qpos", a_q, new_r.qpos, st.qpos),
                ("qvel", a_v, new_r.qvel, st.qvel),
                ("reward", rew, out_r.reward, None)):
            gaps[key + "_gap"] = max(gaps[key + "_gap"],
                                     spread_gap(got_x, want_x, base))
            gaps[key + "_max"] = max(gaps[key + "_max"],
                                     gap(got_x, want_x, base))
        if control:
            # the fault "a step that returns its state unchanged", planted
            # in the reference put in the program's place
            _, out_u = E.finish_step(ref.w.model, p, ref.w.tables,
                                     ref.w.expert, st, st.qpos, st.qvel,
                                     it["end_reward"])
            for key, got_x, want_x, base in (
                    ("qpos_gap", st.qpos, new_r.qpos, st.qpos),
                    ("qvel_gap", st.qvel, new_r.qvel, st.qvel),
                    ("reward_gap", out_u.reward, out_r.reward, None)):
                unchanged[key] = max(unchanged.get(key, 0.0),
                                     spread_gap(got_x, want_x, base))
        head = engine.fk(ref.w.model, new_r.qpos).xpos[
            :, ref.w.tables.head_body, 2]
        thr = ref.w.expert.head_height_lb[new_r.expert_ind] - 0.1
        clear = (head - thr).abs() > FLAG_MARGIN
        flags += int(((fail.to(device) != out_r.fail) & clear).sum())
        if not control:
            # the state each next step started from
            q_next = it["s_qpos"][1:].to(device, torch.float64)
            v_next = it["s_qvel"][1:].to(device, torch.float64)
            fell = it["fail"][:-1].to(device)
            rq, rv = ref.reanchor(
                flat(it["s_expert_ind"][:-1]).to(device),
                flat(it["s_start_ind"][:-1]).to(device),
                flat(it["s_cur_t"][:-1]).to(device) + 1,
                noise.anchor_noise[:-1, L.to(gen_dev)].reshape(
                    -1, p.nq - 7).to(device))
            rq = rq.reshape(T - 1, len(L), -1)
            rv = rv.reshape(T - 1, len(L), -1)
            aq = it["after_qpos"][:-1].to(device, torch.float64)
            av = it["after_qvel"][:-1].to(device, torch.float64)
            want_q = torch.where(fell[..., None], rq, aq)
            want_v = torch.where(fell[..., None], rv, av)
            gaps["next_gap"] = max(gaps["next_gap"],
                                   gap(flat(q_next), flat(want_q)),
                                   gap(flat(v_next), flat(want_v)))
        # the update, on the program's batch
        lr = float(cfg.policy_lr)
        ploss_r, vloss_r = ref.update(it, lr)
        if control:
            with tf32():
                ploss, vloss = side.update(it, lr)
        else:
            ploss, vloss = next(losses)
        for got_l, want_l in ((ploss, ploss_r), (vloss, vloss_r)):
            gaps["loss_gap"] = max(gaps["loss_gap"], abs(got_l - want_l)
                                   / max(abs(want_l), 1e-12))
        if k == 0:
            ref_first = ref.first_grads()
            side_first = side.first_grads() if control else None
        if it.get("window"):
            # the change of the weights in this one update
            base = [x.to(device, torch.float64)
                    for x in win["params_before"]]
            d_ref_w = [a.detach() - b for a, b in zip(ref.leaves(), base)]
            if control:
                d_got_w = [a.detach().double() - b
                           for a, b in zip(side.leaves(), base)]
            else:
                d_got_w = [a.to(device, torch.float64) - b for a, b in
                           zip(win["params_after"], base)]
            gaps["window_change_gap"] = leaf_gap(
                d_got_w, d_ref_w, kept(ref.first_grads()))
        else:
            ref_losses.append((ploss_r, vloss_r))
            if it is warm[-1]:
                warm_ref = [x.detach().clone() for x in ref.leaves()]
                warm_side = [x.detach().clone() for x in side.leaves()] \
                    if control else None
    out.update(gaps)
    out["flag_mismatch"] = flags
    out["draw_mismatch"] = draws
    # the first gradient of each optimizer, by the worst leaf
    got_first = side_first if control else prog["first_grads"]
    out["grad_gap"] = leaf_gap(got_first, ref_first)
    # the change of the weights over the warm-up, leaves with a gradient in
    # the reference (both lists run policy, policy context, value, value
    # context)
    keep = kept(ref_first)
    d_ref = [a - b for a, b in zip(warm_ref, ref_init)]
    if control:
        d_got = [a - b for a, b in zip(warm_side, side.init)]
    else:
        d_got = [a.to(device) - b.to(device)
                 for a, b in zip(prog["params_after"],
                                 prog["params_before"])]
    out["change_gap"] = max(leaf_gap(d_got, d_ref, keep),
                            out.pop("window_change_gap"))
    if control:
        out["fault_unchanged"] = unchanged
        out["fault_half"] = half_batch_fault(
            kind, cfg, n_takes, t_len, ckpt, lanes, warm, device,
            ref_losses, ref_first, d_ref, keep)
    return out


def kept(first_grads):
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's norm."""
    norms = torch.stack([g.double().norm().cpu() for g in first_grads])
    return norms >= 1e-3 * torch.median(norms)


def half_batch_fault(kind, cfg, n_takes, t_len, ckpt, lanes, iters, device,
                     ref_losses, ref_first, d_ref, keep) -> dict:
    """The fault "half of the batch left out, the mean taken over the
    rest", planted in the reference put in the program's place: each
    update on the first half of the lanes, judged as the program is."""
    half = Ref(kind, cfg, n_takes, t_len, ckpt, lanes, torch.float64,
               device)
    h = lanes // 2
    loss = 0.0
    for it, (p_r, v_r) in zip(iters, ref_losses):
        part = dict(it)
        for k in ("states", "actions", "rewards", "masks", "exps",
                  "valids"):
            part[k] = it[k][:, :h]
        for k in ("expert_ind", "start_ind"):
            part[k] = it[k][:h]
        p_h, v_h = half.update(part, float(cfg.policy_lr))
        loss = max(loss, abs(p_h - p_r) / max(abs(p_r), 1e-12),
                   abs(v_h - v_r) / max(abs(v_r), 1e-12))
    first = half.opts[0].first_grad + half.opts[1].first_grad
    d_half = [a.detach() - b for a, b in zip(half.leaves(), half.init)]
    return dict(loss_gap=loss, grad_gap=leaf_gap(first, ref_first),
                change_gap=leaf_gap(d_half, d_ref, keep))


class tf32:
    """TF32 matmuls and convolutions for the block (the control)."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
