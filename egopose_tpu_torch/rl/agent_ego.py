"""AgentEgo: video-conditioned policy optimization, sampling and updates
(counterpart of egopose_tpu/rl/agent_ego.py).

Holds the policy, value and video-context nets, the observation filter
(zstat) and the two optimizers; samples batches of segments through
rl/rollout.py and updates through rl/ppo.py (``policy_objective`` ppo or
a2c) or rl/trpo.py (trpo).  Checkpoints are pickles in the JAX package's
layout (flax trees of numpy arrays + RunningStat), so either package loads
what the other saves; the reference code base's checkpoints (torch
state_dicts + a pickled ZFilter) load too.  The native checkpoint
(``save_native``) also carries both optimizers' states.

``mesh`` (parallel/mesh.py) makes the agent one data-parallel rank: it
samples and updates its slice of the ``batch_lanes`` lanes.  Every rank
draws the segment's noise for all lanes from the same generator and keeps
its slice, so the noise is bitwise the one-process noise; the observation
filter, the sample log and the update's sums run over every rank's lanes
(rl/ppo.py).  A ``time`` axis time-shards the TCN context encodes of the
rollout and of the update (parallel/seqpar.py).  The lead rank writes the
checkpoints; every rank loads them.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from ..convert import params_from_jax, params_to_jax, save_checkpoint_pickle
from ..models.video_state_net import VideoStateNet
from ..ops import running_norm
from ..parallel import mesh as meshlib
from ..parallel import seqpar
from . import ppo, rollout, trpo
from .nets import PolicyGaussian, Value

NATIVE_FILE = "checkpoint.pt"     # the file inside a native checkpoint
NET_KEYS = ("policy_dict", "policy_vs_dict", "value_dict", "value_vs_dict")


class SampleLog(NamedTuple):
    num_steps: float
    num_episodes: float
    avg_episode_len: float
    avg_c_reward: float
    min_c_reward: float
    max_c_reward: float
    avg_c_info: np.ndarray
    fail_rate: float
    sample_time: float = 0.0


def check_mesh(cfg, batch_lanes: int, dp: int, sp: int, axis="data"):
    """Raise where a (dp x sp) mesh cannot take the config: lanes that do
    not split over ``dp``, sequence parallelism (sp > 1) without TCN
    context nets."""
    if batch_lanes % dp:
        raise ValueError(f"batch_lanes={batch_lanes} not divisible by the "
                         f"{axis!r} mesh axis ({dp})")
    if sp > 1 and (cfg.policy_v_net != "tcn" or cfg.value_v_net != "tcn"):
        raise ValueError(
            "a 'time' mesh axis (sequence parallelism) requires TCN context "
            f"nets (got policy={cfg.policy_v_net!r}, "
            f"value={cfg.value_v_net!r})")


class AgentEgo:
    def __init__(self, model, spec, params, tables, expert, cnn_feat, cfg,
                 batch_lanes: int = 1024, seed: int = 1,
                 dtype=torch.float32, device="cpu", mesh=None):
        self.model, self.spec, self.p, self.tables = model, spec, params, \
            tables
        self.mesh, self.data, self.time_axis = mesh, None, None
        if mesh is not None:
            axis = mesh.axis_names[0]
            sp = mesh.size(mesh.axis_names[1]) \
                if len(mesh.axis_names) > 1 else 1
            check_mesh(cfg, batch_lanes, mesh.size(axis), sp, axis)
            self.data = meshlib.Group(mesh, axis)
            if sp > 1:
                self.time_axis = mesh.axis_names[1]
        self.dtype, self.device = dtype, torch.device(device)
        self.expert = expert
        self.cnn_feat = torch.as_tensor(np.asarray(cnn_feat)).to(
            device=self.device, dtype=dtype)
        self.cfg = cfg
        self.batch_lanes = batch_lanes
        self.end_reward = 0.0
        self.noise_rate = 1.0
        obs_dim = params.obs_dim
        # fresh weights come from a seeded generator without touching the
        # caller's global random state
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            (self.policy_net, self.value_net, self.policy_vs_net,
             self.value_vs_net) = self._make_nets(
                obs_dim, self.cnn_feat.shape[-1], spec.nu, cfg)
        for net in self.nets:
            net.to(device=self.device, dtype=dtype).eval()
        if mesh is not None:
            meshlib.replicate(mesh, self.nets)
        self.zstat = running_norm.init_stat(obs_dim, dtype, self.device)
        opt_p, opt_v = ppo.make_optimizers(
            [*self.policy_net.parameters(), *self.policy_vs_net.parameters()],
            [*self.value_net.parameters(), *self.value_vs_net.parameters()],
            cfg.policy_lr, cfg.value_lr, grad_clip=40.0,
            policy_weight_decay=cfg.policy_weightdecay,
            value_weight_decay=cfg.value_weightdecay)
        self.train_state = ppo.TrainState(
            policy=self.policy_net, policy_vs=self.policy_vs_net,
            value=self.value_net, value_vs=self.value_vs_net,
            opt_policy=opt_p, opt_value=opt_v)
        self.hyper = ppo.PPOHyper(
            gamma=cfg.gamma, tau=cfg.tau, clip_epsilon=cfg.clip_epsilon,
            num_epochs=cfg.num_optim_epoch,
            kl_target=float(getattr(cfg, "policy_kl_target", 0.0) or 0.0))
        # optional shuffled-minibatch PPO: cfg counts steps, the slices
        # are lane-grained
        mbs = getattr(cfg, "mini_batch_size", None)
        self.mini_batch_lanes = 0
        if mbs and mbs < batch_lanes * params.env_episode_len:
            self.mini_batch_lanes = max(1, int(mbs) // params.env_episode_len)
        self.update_generator = torch.Generator(device=self.device)
        self.update_generator.manual_seed(seed + 17)
        # "ppo" (the shipped configs), "a2c" (the vanilla policy gradient)
        # or "trpo"
        self.objective = getattr(cfg, "policy_objective", None) or "ppo"
        if self.objective not in ("ppo", "a2c", "trpo"):
            raise ValueError(f"policy_objective must be ppo|a2c|trpo, got "
                             f"{self.objective!r}")
        self.trpo_hyper = trpo.TRPOHyper(
            max_kl=float(getattr(cfg, "max_kl", None) or 1e-2),
            damping=float(getattr(cfg, "cg_damping", None) or 1e-2),
            cg_iters=int(getattr(cfg, "cg_iters", None) or 10)) \
            if self.objective == "trpo" else None

    @staticmethod
    def _make_nets(obs_dim, cnn_fdim, nu, cfg):
        """(policy, value, policy context, value context) nets with fresh
        weights, made in this order."""
        return (PolicyGaussian(obs_dim + cfg.policy_v_hdim, nu,
                               cfg.policy_hsize, cfg.policy_htype,
                               cfg.log_std, cfg.fix_std),
                Value(obs_dim + cfg.value_v_hdim, cfg.value_hsize,
                      cfg.value_htype),
                VideoStateNet(cnn_fdim, cfg.policy_v_hdim, cfg.fr_margin,
                              cfg.policy_v_net, cfg.causal,
                              cfg.policy_v_net_param),
                VideoStateNet(cnn_fdim, cfg.value_v_hdim, cfg.fr_margin,
                              cfg.value_v_net, cfg.causal,
                              cfg.value_v_net_param))

    @property
    def nets(self):
        return (self.policy_net, self.policy_vs_net, self.value_net,
                self.value_vs_net)

    # -- the schedule's hooks (ego_mimic.py: pre-iteration updates) ---------
    def set_noise_rate(self, r):
        self.noise_rate = float(r)

    def set_policy_lr(self, lr):
        self.train_state.opt_policy.lr = float(lr)

    def fill_log_std(self, log_std):
        with torch.no_grad():
            self.policy_net.action_log_std.fill_(float(log_std))

    # -- sampling -------------------------------------------------------------
    def sample(self, generator: torch.Generator, min_batch_size: int,
               mean_action: bool = False):
        """ceil(min_batch_size / (lanes * episode_len)) segments, lanes
        concatenated.  Returns (SegmentBatch, SampleLog)."""
        t0 = time.time()
        per_seg = self.batch_lanes * self.p.env_episode_len
        n_seg = max(1, math.ceil(min_batch_size / per_seg))
        segs = []
        for _ in range(n_seg):
            noise = rollout.draw_segment_noise(
                self.p, self.expert, self.batch_lanes, self.noise_rate,
                generator)
            if self.mesh is not None:
                # lanes lead the reset fields, follow time in the others
                noise = rollout.SegmentNoise(*[
                    meshlib.lane_slice(self.mesh, x, self.data.axis,
                                       dim=1 if i >= 4 else 0)
                    for i, x in enumerate(noise)])
            seg, self.zstat = self._rollout(noise, mean_action)
            segs.append(seg)
        batch = rollout.SegmentBatch(*[
            torch.cat(xs, 1 if xs[0].dim() > 1 else 0)
            for xs in zip(*segs)]) if n_seg > 1 else segs[0]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return batch, self._make_log(batch, time.time() - t0)

    def _rollout(self, noise, mean_action):
        """One segment from ``noise``: (SegmentBatch, new zstat)."""
        encode = self.policy_vs_net if self.time_axis is None else \
            (lambda w: seqpar.vsnet_encode_sp(self.mesh, self.policy_vs_net,
                                              w, axis=self.time_axis))
        return rollout.rollout_segment(
            self.model, self.p, self.tables, self.expert, self.cnn_feat,
            self.policy_net, encode, self.zstat, noise, mean_action,
            self.end_reward, group=self.data)

    def _make_log(self, batch, dt):
        """The segment's statistics over every rank's lanes: the sums
        and the extremes reduced over the ranks, in float64."""
        valid = batch.valids.double()
        rewards = batch.rewards.double()
        fails = batch.fails.double() * valid
        info = batch.reward_info.double()
        big = torch.tensor(torch.inf, dtype=torch.float64,
                           device=valid.device)
        sums = torch.cat([torch.stack([
            valid.sum(), torch.tensor(float(valid.shape[1]),
                                      dtype=torch.float64,
                                      device=valid.device),
            fails.sum(), (rewards * valid).sum()]),
            (info * valid[..., None]).sum((0, 1))])
        # (-min, max): both reduce by max
        ext = torch.stack([torch.where(valid > 0, -rewards, -big).max(),
                           torch.where(valid > 0, rewards, -big).max()])
        if self.mesh is not None:
            sums = self.data.sum(sums)
            ext = meshlib.all_reduce(self.mesh, ext, self.data.axis, "max")
        sums, (neg_min, r_max) = sums.cpu().numpy(), ext.cpu().numpy()
        n_steps, lanes, n_fail, r_sum = sums[:4]
        # every lane is one episode, plus one per mid-segment re-anchor
        n_eps = lanes + n_fail
        vsum = max(n_steps, 1.0)
        return SampleLog(
            num_steps=float(n_steps), num_episodes=float(n_eps),
            avg_episode_len=float(n_steps / n_eps),
            avg_c_reward=float(r_sum / vsum),
            min_c_reward=float(-neg_min) if n_steps else 0.0,
            max_c_reward=float(r_max) if n_steps else 0.0,
            avg_c_info=sums[4:] / vsum,
            fail_rate=float(n_fail / n_eps),
            sample_time=dt)

    # -- update ---------------------------------------------------------------
    def update_params(self, batch) -> dict:
        """One update of the objective on a sampled batch; its metrics as
        floats (TRPO adds ``kl``, ``surrogate_after`` and ``ls_success``),
        with both optimizers' non-finite-gradient skip counts."""
        return self._host_metrics(self._update(batch, self._windows(batch)))

    def _update(self, batch, windows) -> dict:
        """The objective's update on ``batch``: its metrics as tensors."""
        if self.objective == "trpo":
            _, metrics = trpo.trpo_update(self.train_state, self.hyper,
                                          self.trpo_hyper, batch, windows,
                                          mesh=self.mesh)
        else:
            lanes = self.batch_lanes if self.mesh is None else \
                self.batch_lanes // self.mesh.size(self.data.axis)
            _, metrics = ppo.ppo_update(
                self.train_state, self.hyper, batch, windows,
                mini_batch_lanes=self.mini_batch_lanes,
                generator=self.update_generator, objective=self.objective,
                mesh=self.mesh, segments=batch.rewards.shape[1] // lanes)
        return metrics

    def _host_metrics(self, metrics: dict) -> dict:
        out = {k: float(v) for k, v in metrics.items()}
        # non-finite-gradient skips (Adam's apply_if_finite counters)
        for name in ("policy", "value"):
            opt = getattr(self.train_state, "opt_" + name)
            out[f"{name}_grad_skips"] = int(opt.total_notfinite)
        return out

    def _windows(self, batch):
        """The context nets' video windows of a batch's lanes."""
        return rollout.gather_windows(
            self.cnn_feat, batch.expert_ind, batch.start_ind,
            self.p.fr_margin, self.p.env_episode_len)

    # -- checkpoints ----------------------------------------------------------
    def checkpoint(self) -> dict:
        """The JAX package's checkpoint dict: flax trees + RunningStat, all
        numpy."""
        trees = params_to_jax(*[net.state_dict() for net in self.nets])
        np_ = lambda x: x.detach().cpu().numpy()
        return {**dict(zip(NET_KEYS, trees)),
                "running_state": running_norm.RunningStat(
                    n=np_(self.zstat.n), mean=np_(self.zstat.mean),
                    s=np_(self.zstat.s))}

    def save(self, path: str):
        meshlib.lead_writes(self.mesh, lambda p: save_checkpoint_pickle(
            p, self.checkpoint()), path)

    def load(self, path: str):
        """Load a checkpoint pickle written by either package's
        AgentEgo.save (flax trees + RunningStat) or by the reference code
        base (torch state_dicts + a pickled ZFilter), told apart by its
        contents."""
        from ..models.torch_import import tolerant_pickle_load
        self.load_checkpoint(tolerant_pickle_load(path))

    def _import_reference_checkpoint(self, cp: dict) -> dict:
        """A reference-format checkpoint -> the port's state_dicts, with
        the context nets' importer of this agent's kind."""
        from ..models import torch_import as ti
        cfg = self.cfg
        return ti.import_mimic_checkpoint(
            cp, bi_dir=not cfg.causal, v_net_type=cfg.policy_v_net,
            value_v_net_type=cfg.value_v_net)

    def load_checkpoint(self, cp: dict):
        """Load a checkpoint dict of either layout.  The nets take the
        session's dtype.  The filter's statistics keep the dtype they were
        stored in, as in the JAX package, unless it is wider than the
        session's: a float64 filter evaluates with float32 nets in float32
        (a float32 filter stays float32 under float64)."""
        from ..models.torch_import import looks_torch_state_dict
        stat = cp["running_state"]
        if looks_torch_state_dict(cp["policy_dict"]):
            cp = self._import_reference_checkpoint(cp)
            # reference checkpoints are float64: the session's dtype wins,
            # for the filter's statistics too (as in the JAX package)
            stat = running_norm.RunningStat(*[
                torch.as_tensor(np.asarray(x)).to(self.dtype)
                for x in cp["running_state"]])
            sds = [cp[k] for k in NET_KEYS]
        else:
            sds = params_from_jax(*[cp[k] for k in NET_KEYS])
        self._load_nets(sds)
        self.zstat = running_norm.to_tensors(
            running_norm.RunningStat(*[self._no_wider(x) for x in stat]),
            self.device)

    def _load_nets(self, sds):
        for net, sd in zip(self.nets, sds):
            net.load_state_dict({k: v.to(self.dtype) for k, v in sd.items()})

    def _no_wider(self, x) -> torch.Tensor:
        """``x`` as a tensor, cast down to the session's dtype where its
        float type is wider."""
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if t.is_floating_point() and t.dtype.itemsize > self.dtype.itemsize:
            t = t.to(self.dtype)
        return t

    # -- the native checkpoint, with the optimizers' states ------------------
    def save_native(self, path: str):
        meshlib.lead_writes(self.mesh, self._save_native, path)

    def _save_native(self, path: str):
        """Write the native checkpoint: the directory ``path``
        (conventionally models/iter_%04d.orbax, the JAX package's
        AgentEgo.save_orbax path) holding one torch.save file with the four
        nets' state_dicts, the filter's statistics and both optimizers'
        states (moments, step and skip counts, learning rate), so a resume
        continues the optimization exactly.  Written to a temporary
        directory beside ``path``, then renamed into place."""
        ts = self.train_state
        state = {
            **{key: {k: v.detach().cpu().clone()
                     for k, v in net.state_dict().items()}
               for key, net in zip(NET_KEYS, self.nets)},
            "running_state": {k: v.detach().cpu().clone()
                              for k, v in self.zstat._asdict().items()},
            "opt_policy": ts.opt_policy.state_dict(),
            "opt_value": ts.opt_value.state_dict()}
        path = os.path.abspath(path)
        parent, name = os.path.split(path)
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".{name}.", dir=parent)
        try:
            torch.save(state, os.path.join(tmp, NATIVE_FILE))
            if os.path.isdir(path):
                old = tmp + ".old"
                os.replace(path, old)
                os.replace(tmp, path)
                shutil.rmtree(old)
            else:
                os.replace(tmp, path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def load_native(self, path: str):
        """Load what save_native wrote: nets, filter and both optimizers.
        A directory without the port's file (an orbax checkpoint of the JAX
        package, say) raises: the checkpoint pickle is the format both
        packages read."""
        f = os.path.join(path, NATIVE_FILE)
        if not os.path.isfile(f):
            raise FileNotFoundError(
                f"{path} holds no {NATIVE_FILE}: not a native checkpoint of "
                "egopose_tpu_torch (the port does not read orbax "
                "checkpoints; the checkpoint pickle iter_%04d.p is the "
                "format both packages read)")
        state = torch.load(f, map_location="cpu", weights_only=True)
        self._load_nets([state[k] for k in NET_KEYS])
        self.zstat = running_norm.to_tensors(
            running_norm.RunningStat(**state["running_state"]), self.device)
        self.train_state.opt_policy.load_state_dict(state["opt_policy"])
        self.train_state.opt_value.load_state_dict(state["opt_value"])
