"""The eval cell's comparison: every control step the program ran, each
judged from the program's own state at that step (the physics is chaotic,
so a float32 trajectory and a float64 one part within a second; each step
is therefore followed from the state the program had, and its answers are
worked out again).

Per step and take the reference works out, in float64: the observation
and the running-norm filter (``zobs_gap``), the bi-LSTM contexts over the whole take
(from the checkpoint file and the seed's synthetic world, never from the
program's tensors), the policy's mean action and the value; the control
step (15 substeps, the split path: the plain version of the program's
K1) from the program's state and action, and the reward; the value
fail-safe's decision and its re-anchored state.

Numbers: ``action_gap``, the largest error over all steps and takes
against the RMS of the reference's actions (the observation, the filter
and the nets at the program's state); ``value_gap``, ``qpos_gap`` and
``qvel_gap`` (the state after the control step, against the RMS of the
reference's change of it in a step) and ``reward_gap``, each the largest
over the takes of the take's PHYSICS_QUANTILE-th quantile of its per-step
errors; ``failsafe_mismatch``, the steps whose fail-safe decision differs
from the reference's away from its threshold; ``reset_gap``, the largest
error of the re-anchored state where both sides re-anchored.  Also worked
out and compared by no limit: ``zobs_gap`` (judged through
``action_gap``), the largest physics errors (``*_max``), the counts of
re-anchors and of states the reference cannot solve.
"""
from __future__ import annotations

import torch

from . import world as W
from .plain import envs as E
from .plain.ops import running_norm

FIELDS = ("qpos", "qvel", "cur_t", "expert_ind", "start_ind", "prev_qpos",
          "prev_bquat", "bquat", "done")
# a decision whose value lies this close (relative) to the fail-safe's
# threshold may go either way on rounding and is not compared
DECISION_MARGIN = 1e-4
CHUNK = 2048
# an observation column whose filter std is below this carries only the
# rounding noise of a quantity that is zero in exact arithmetic (the
# de-headed root quaternion's z: std 1.5e-8 in the checkpoint's filter,
# every other column 3e-3 or more); normalised, it is noise of order one
# that no precision reproduces, so each side's own value of it is used
NOISE_STD = 1e-6


class Side:
    """The reference in one precision: world, nets, filter and contexts."""

    def __init__(self, cfg, n_takes, t_len, ckpt, dtype, device):
        self.dtype, self.device = dtype, device
        self.w = W.build_world(cfg, n_takes, t_len, dtype, device)
        p = self.w.p
        self.nets = W.make_nets("egomimic", cfg, p.obs_dim, p.nu, cfg.seed,
                                dtype, device)
        self.zstat = W.load_mimic_checkpoint(self.nets, ckpt, dtype, device)
        with torch.no_grad():
            self.v_p = self.nets.policy_vs(self.w.cnn_feat)
            self.v_v = self.nets.value_vs(self.w.cnn_feat)
        m = cfg.fr_margin
        self.margin = m
        self.preds = torch.stack([W.kinematic_state_pred(self.w.expert, i)
                                  for i in range(n_takes)])

    def state(self, s: dict):
        cast = lambda x: x.to(self.device, self.dtype) \
            if x.is_floating_point() else x.to(self.device)
        return E.EnvState(*[cast(s[f]) for f in FIELDS])

    def noise_columns(self):
        return running_norm.std(self.zstat) < NOISE_STD

    @torch.no_grad()
    def zobs(self, st):
        return running_norm.apply(self.zstat, E.observe(self.w.p, st),
                                  clip=5.0)

    @torch.no_grad()
    def policy_value(self, st, t_idx, zobs):
        """Mean actions and values of states ``st`` at steps ``t_idx``
        from their filtered observations ``zobs``."""
        b = st.expert_ind
        mean, _ = self.nets.policy(torch.cat([self.v_p[b, t_idx], zobs], -1))
        value = self.nets.value(torch.cat([self.v_v[b, t_idx], zobs], -1))
        return mean, value

    @torch.no_grad()
    def step(self, st, action):
        """(qpos, qvel, reward) after one control step, in chunks."""
        outs = []
        for i in range(0, st.qpos.shape[0], CHUNK):
            sl = E.EnvState(*[x[i:i + CHUNK] for x in st])
            new, out = E.step(self.w.model, self.w.p, self.w.tables,
                              self.w.expert, sl,
                              action[i:i + CHUNK].to(self.dtype), 0.0)
            outs.append((new.qpos, new.qvel, out.reward))
        return [torch.cat(x) for x in zip(*outs)]

    def reset_state(self, qpos_after, take, t):
        """The fail-safe's re-anchored (qpos, qvel) after step ``t``."""
        row = self.preds[take, self.margin + t + 1]
        return W.reset_to_pred(self.w.p, self.w.tables,
                               qpos_after.to(self.dtype), row)

    def decisions(self, values, n_steps, n_takes):
        """The fail-safe's decision and its distance from the threshold,
        (T, takes) each, from values (T * takes) in step-major order."""
        v = values.reshape(n_steps, n_takes).double()
        n = torch.arange(1, n_steps + 1, device=v.device,
                         dtype=torch.float64)[:, None]
        mean = torch.cumsum(v, 0) / n
        thr = 0.6 * mean
        return v < thr, (v - thr).abs() / thr.abs().clamp(min=1e-12)


def row_errors(got, want, base=None):
    """Per row (one state, one lane-step), the largest absolute difference,
    over the RMS of the reference's values -- or, given the state before
    the step ``base``, of the reference's change of it."""
    want = want.double()
    got = got.double().to(want.device)
    err = (got - want).abs().reshape(want.shape[0], -1).amax(1) \
        if want.dim() > 1 else (got - want).abs()
    ref = want if base is None else want - base.double().to(want.device)
    rms = torch.sqrt(torch.mean(ref ** 2)).clamp(min=1e-300)
    return torch.where(torch.isfinite(err), err / rms,
                       torch.full_like(err, float("inf")))


def gap(got, want, base=None) -> float:
    """The largest row error (row_errors)."""
    return float(row_errors(got, want, base).max())


# the quantile answers are judged by: a contact row that activates on one
# side of its margin and not on the other moves a state far in a step, on
# a few states of a take, in any precision below the reference's alike
PHYSICS_QUANTILE = 0.9


def spread_gap(got, want, base=None, q=PHYSICS_QUANTILE) -> float:
    """The ``q``-th quantile of the row errors."""
    return float(torch.quantile(row_errors(got, want, base), q))


def take_gap(got, want, n_takes, base=None, q=PHYSICS_QUANTILE) -> float:
    """The largest, over the takes, of each take's ``q``-th quantile of
    its row errors (rows in step-major order): a fault in one take shows
    however few the takes it leaves alone."""
    err = row_errors(got, want, base).reshape(-1, n_takes)
    return float(torch.quantile(err, q, dim=0).max())


def check(cfg, n_takes, t_len, ckpt, rec, device, control=False) -> dict:
    """The numbers for recorded steps ``rec``: a dict of (T, takes, ...)
    CPU tensors -- the state fields before each step (FIELDS), ``action``,
    ``value``, ``zobs``, the program's state after the physics
    (``after_qpos``, ``after_qvel``), ``reward``, and the state the next
    step started from (``next_qpos``, ``next_qvel``, T-1 of them).  With
    ``control`` the program's answers are replaced by the reference's own
    in float32 with TF32 on (the control), judged the same way, and the
    faults' readings are added (``fault_unchanged``, ``fault_late_anchor``)."""
    n_steps = rec["action"].shape[0]
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    t_idx = torch.arange(n_steps, device=device).repeat_interleave(n_takes)
    ref = Side(cfg, n_takes, t_len, ckpt, torch.float64, device)
    st = ref.state({f: flat(rec[f]) for f in FIELDS})
    z_ref = ref.zobs(st)
    noise = ref.noise_columns()
    if control:
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            ctl = Side(cfg, n_takes, t_len, ckpt, torch.float32, device)
            st_c = ctl.state({f: flat(rec[f]) for f in FIELDS})
            zobs = ctl.zobs(st_c)
            action, value = ctl.policy_value(st_c, t_idx, zobs)
            qpos, qvel, reward = ctl.step(st_c, action)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        reset = ctl.decisions(value, n_steps, n_takes)[0][:-1]
        anchored = lambda t, b: ctl.reset_state(
            qpos.reshape(n_steps, n_takes, -1)[t, b], b, t)
    else:
        dev = lambda x: flat(x).to(device)
        action, value = dev(rec["action"]), dev(rec["value"])
        qpos, qvel = dev(rec["after_qpos"]), dev(rec["after_qvel"])
        reward, zobs = dev(rec["reward"]), dev(rec["zobs"])
        nq, nv = rec["next_qpos"].to(device), rec["next_qvel"].to(device)
        reset = ~(nq == rec["after_qpos"][:-1].to(device)).all(-1)
        anchored = lambda t, b: (nq[t, b], nv[t, b])
    # the policy sees the reference's filtered observation, and the side's
    # own values in the columns of rounding noise
    z_in = torch.where(noise, zobs.to(z_ref.dtype), z_ref)
    a_ref, v_ref = ref.policy_value(st, t_idx, z_in)
    q_ref, v_ref_phys, r_ref = ref.step(st, action)
    out = dict(zobs_gap=gap(zobs[:, ~noise], z_ref[:, ~noise]),
               action_gap=gap(action, a_ref),
               value_gap=take_gap(value, v_ref, n_takes),
               qpos_gap=take_gap(qpos, q_ref, n_takes, st.qpos),
               qvel_gap=take_gap(qvel, v_ref_phys, n_takes, st.qvel),
               reward_gap=take_gap(reward, r_ref, n_takes),
               qpos_max=gap(qpos, q_ref, st.qpos),
               qvel_max=gap(qvel, v_ref_phys, st.qvel),
               reward_max=gap(reward, r_ref))
    # the fail-safe: the decision away from its threshold, and the
    # re-anchored state where both sides re-anchored
    trig_ref, dist = ref.decisions(v_ref, n_steps, n_takes)
    trig_ref, dist = trig_ref[:-1].to(reset.device), dist[:-1].to(
        reset.device)
    clear = dist > DECISION_MARGIN
    out["failsafe_mismatch"] = int(((reset != trig_ref) & clear).sum())
    both = (reset & trig_ref).nonzero()
    out["reset_gap"] = 0.0
    if len(both):
        t, b = both[:, 0], both[:, 1]
        rq, rv = ref.reset_state(qpos.reshape(n_steps, n_takes, -1)[t, b],
                                 b, t)
        got_q, got_v = anchored(t, b)
        out["reset_gap"] = max(gap(got_q, rq), gap(got_v, rv))
    out["resets"] = int(reset.sum())
    # states whose step the reference could not solve (a system that is
    # not positive definite): counted, and their largest speed
    bad = ~torch.isfinite(q_ref).all(-1)
    out["unsolved"] = int(bad.sum())
    out["unsolved_speed"] = float(st.qvel[bad].abs().max()) if bool(
        bad.any()) else 0.0
    if control:
        out["fault_unchanged"], out["fault_late_anchor"] = faults(
            ref, st, q_ref, v_ref_phys, r_ref, qpos, trig_ref, n_steps,
            n_takes)
    return out


def faults(ref, st, q_ref, v_ref, r_ref, qpos, trig, n_steps, n_takes):
    """Two faults planted in the reference put in the program's place,
    judged as the program is: a step that returns its state unchanged
    (its reward from that state), and the fail-safe re-anchoring to the
    next frame's state instead of its own."""
    w = ref.w
    _, out_u = E.finish_step(w.model, w.p, w.tables, w.expert, st, st.qpos,
                             st.qvel, 0.0)
    unchanged = dict(qpos_gap=take_gap(st.qpos, q_ref, n_takes, st.qpos),
                     qvel_gap=take_gap(st.qvel, v_ref, n_takes, st.qvel),
                     reward_gap=take_gap(out_u.reward, r_ref, n_takes))
    late = None
    at = trig.nonzero()
    if len(at):
        t, b = at[:, 0], at[:, 1]
        q = qpos.reshape(n_steps, n_takes, -1)[t, b]
        rq, rv = ref.reset_state(q, b, t)
        lq, lv = ref.reset_state(q, b, t + 1)
        late = max(gap(lq, rq), gap(lv, rv))
    return unchanged, late
