"""YAML config for the state-regression, ego-mimic and ego-forecast
workloads (counterpart of egopose_tpu/utils/config.py): the same schemas,
results-directory contract and adaptive schedules, plus
``make_env_params`` which compiles the env-relevant subset into the
port's EnvParams."""
from __future__ import annotations

import os

import numpy as np
import torch
import yaml

from ..physics import engine
from ..physics.spec import ModelSpec


def _interp_schedule(cp_iters, cp_values, i_iter):
    """Piecewise-linear schedule (egomimic_config.py:124-131)."""
    cp = np.asarray(cp_iters)
    v = np.asarray(cp_values, dtype=float)
    ind = np.where(i_iter >= cp)[0][-1]
    nind = ind + int(ind < len(cp) - 1)
    t = (i_iter - cp[ind]) / (cp[nind] - cp[ind]) if nind > ind else 0.0
    return v[ind] * (1 - t) + v[nind] * t


class ConfigBase:
    """Shared YAML loading + directory conventions."""

    workload = None  # 'statereg' | 'egomimic' | 'egoforecast'

    def __init__(self, cfg_id=None, create_dirs=False, cfg_dict=None,
                 base_dir="results", data_dir="datasets",
                 config_root="config"):
        self.id = cfg_id
        if cfg_dict is not None:
            cfg = cfg_dict
        else:
            path = os.path.join(config_root, self.workload, f"{cfg_id}.yml")
            if not os.path.exists(path):
                raise FileNotFoundError(f"Config file doesn't exist: {path}")
            cfg = yaml.safe_load(open(path))
        self._cfg = cfg

        self.base_dir = base_dir
        self.cfg_dir = f"{base_dir}/{self.workload}/{cfg_id}"
        self.model_dir = f"{self.cfg_dir}/models"
        self.result_dir = f"{self.cfg_dir}/results"
        self.log_dir = f"{self.cfg_dir}/log"
        self.tb_dir = f"{self.cfg_dir}/tb"
        if create_dirs:
            for d in (self.model_dir, self.result_dir, self.log_dir, self.tb_dir):
                os.makedirs(d, exist_ok=True)

        self.data_dir = data_dir
        self.meta_id = cfg.get("meta_id")
        self.meta = None
        self.takes = {"train": [], "test": []}
        if self.meta_id:
            meta_path = f"{data_dir}/meta/{self.meta_id}.yml"
            if os.path.exists(meta_path):
                self.meta = yaml.safe_load(open(meta_path))
                self.takes = {x: self.meta.get(x, []) for x in ("train", "test")}
        self.seed = cfg.get("seed", 1)


class EgoMimicConfig(ConfigBase):
    """Mirrors egomimic_config.Config (egomimic_config.py:7-131)."""

    workload = "egomimic"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self._cfg
        self.expert_feat_file = f"{self.data_dir}/features/expert_{cfg['expert_feat']}.p" \
            if "expert_feat" in cfg else None
        self.cnn_feat_file = f"{self.data_dir}/features/cnn_feat_{cfg['cnn_feat']}.p" \
            if "cnn_feat" in cfg else None
        self.fr_margin = cfg.get("fr_margin", 10)

        self.state_net_cfg = cfg.get("state_net_cfg")
        self.state_net_iter = cfg.get("state_net_iter")
        if self.state_net_cfg is not None:
            self.state_net_model = (f"{self.base_dir}/statereg/{self.state_net_cfg}"
                                    f"/models/iter_{self.state_net_iter:04d}_inf.p")

        g = cfg.get
        self.gamma = g("gamma", 0.95)
        self.tau = g("tau", 0.95)
        self.causal = g("causal", False)
        self.policy_htype = g("policy_htype", "relu")
        self.policy_hsize = g("policy_hsize", [300, 200])
        self.policy_v_hdim = g("policy_v_hdim", 128)
        self.policy_v_net = g("policy_v_net", "lstm")
        self.policy_v_net_param = g("policy_v_net_param", None)
        self.policy_optimizer = g("policy_optimizer", "Adam")
        self.policy_lr = g("policy_lr", 5e-5)
        self.policy_momentum = g("policy_momentum", 0.0)
        self.policy_weightdecay = g("policy_weightdecay", 0.0)
        self.value_htype = g("value_htype", "relu")
        self.value_hsize = g("value_hsize", [300, 200])
        self.value_v_hdim = g("value_v_hdim", 128)
        self.value_v_net = g("value_v_net", "lstm")
        self.value_v_net_param = g("value_v_net_param", None)
        self.value_optimizer = g("value_optimizer", "Adam")
        self.value_lr = g("value_lr", 3e-4)
        self.value_momentum = g("value_momentum", 0.0)
        self.value_weightdecay = g("value_weightdecay", 0.0)
        self.adv_clip = g("adv_clip", np.inf)
        self.clip_epsilon = g("clip_epsilon", 0.2)
        # optional PPO trust-region early stop (PPOHyper.kl_target); 0/absent
        # = reference-exact update with no KL guard
        self.policy_kl_target = g("policy_kl_target", 0.0)
        self.log_std = g("log_std", -2.3)
        self.fix_std = g("fix_std", False)
        self.num_optim_epoch = g("num_optim_epoch", 10)
        self.min_batch_size = g("min_batch_size", 50000)
        # optional shuffled-minibatch PPO (agent_ppo.py:24-43); steps per
        # minibatch, None/absent = full-batch epochs
        self.mini_batch_size = g("mini_batch_size", None)
        # "ppo" (default, AgentPPO), "a2c" (vanilla-PG AgentPG,
        # agents/agent_pg.py:28-38) or "trpo" (AgentTRPO,
        # agents/agent_trpo.py:43-137) -- framework extension key
        self.policy_objective = g("policy_objective", "ppo")
        # TRPO hyperparameters (agents/agent_trpo.py:44-47 defaults)
        self.max_kl = g("max_kl", 1e-2)
        self.cg_damping = g("cg_damping", 1e-2)
        self.cg_iters = g("cg_iters", 10)
        # optional VGAIL discriminator block (ego_pose/core/agent_vgail.py):
        # {hidden_dims, lr, num_update, reward_weight} -- absent = plain
        # AgentEgo, present = AgentVGAIL with -log D(s) reward shaping
        self.discriminator = g("discriminator", None)
        self.max_iter_num = g("max_iter_num", 1000)
        self.save_model_interval = g("save_model_interval", 100)
        self.reward_id = g("reward_id", "quat_v3")
        self.reward_weights = g("reward_weights", None) or {}

        # adaptive schedules (egomimic_config.py:82-91)
        self.adp_iter_cp = np.array(g("adp_iter_cp", [0]))
        n = self.adp_iter_cp.size

        def padded(key, default):
            v = np.array(g(key, [default]), dtype=float)
            return np.pad(v, (0, n - v.size), "edge")

        self.adp_noise_rate_cp = padded("adp_noise_rate_cp", 1.0)
        self.adp_log_std_cp = padded("adp_log_std_cp", self.log_std)
        self.adp_policy_lr_cp = padded("adp_policy_lr_cp", self.policy_lr)
        self.adp_noise_rate = None
        self.adp_log_std = None
        self.adp_policy_lr = None

        # env config
        self.mujoco_model = cfg.get("mujoco_model", "humanoid_1205_v1")
        self.vis_model = cfg.get("vis_model", "humanoid_1205_vis")
        self.env_start_first = g("env_start_first", False)
        self.env_init_noise = g("env_init_noise", 0.0)
        self.env_episode_len = g("env_episode_len", 200)
        self.obs_type = g("obs_type", "full")
        self.obs_coord = g("obs_coord", "heading")
        self.obs_heading = g("obs_heading", False)
        self.obs_vel = g("obs_vel", "full")
        self.obs_phase = g("obs_phase", False)
        self.random_cur_t = g("random_cur_t", False)
        self.root_deheading = g("root_deheading", True)
        self.sync_exp_interval = g("sync_exp_interval", 100)
        self.action_type = g("action_type", "position")
        # torque-mode model overrides (humanoid_v1.py:56-59 set_model_params:
        # jnt_stiffness[1:] = j_stiff, dof_damping[6:] = j_damp)
        self.j_stiff = g("j_stiff", None)
        self.j_damp = g("j_damp", None)
        # engine prep-refresh cadence override (ContactParams.prep_refresh);
        # absent = the engine default, 1 = MuJoCo-C reference behavior
        self.prep_refresh = g("prep_refresh", None)

        # joint params (egomimic_config.py:108-116)
        if "joint_params" in cfg:
            jparam = [np.array(p) for p in zip(*cfg["joint_params"])]
            self.jkp, self.jkd, self.a_ref, self.a_scale, self.torque_lim = \
                [x.astype(float) for x in jparam[1:6]]
            self.a_ref = np.deg2rad(self.a_ref)
            jkp_mult = g("jkp_multiplier", 1.0)
            jkd_mult = g("jkd_multiplier", jkp_mult)
            self.jkp = self.jkp * jkp_mult
            self.jkd = self.jkd * jkd_mult
        if "body_params" in cfg:
            bparam = [np.array(p) for p in zip(*cfg["body_params"])]
            self.b_diffw = bparam[1].astype(float)
        else:
            self.b_diffw = None

    def update_adaptive_params(self, i_iter):
        self.adp_noise_rate = _interp_schedule(self.adp_iter_cp,
                                               self.adp_noise_rate_cp, i_iter)
        self.adp_log_std = _interp_schedule(self.adp_iter_cp,
                                            self.adp_log_std_cp, i_iter)
        self.adp_policy_lr = _interp_schedule(self.adp_iter_cp,
                                              self.adp_policy_lr_cp, i_iter)


class EgoForecastConfig(EgoMimicConfig):
    """The ego-forecast schema (egoforecast_config.py:7-138): the ego-mimic
    keys plus the warm-start source, the state nets, the end-reward flag
    and the adaptive init-noise schedule."""

    workload = "egoforecast"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        g = self._cfg.get
        self.ego_mimic_cfg = g("ego_mimic_cfg")
        self.ego_mimic_iter = g("ego_mimic_iter")
        self.fr_margin = g("fr_margin", 30)
        self.policy_s_net = g("policy_s_net", "id")
        self.policy_s_hdim = g("policy_s_hdim", None)
        self.policy_dyn_v = g("policy_dyn_v", False)
        self.value_s_net = g("value_s_net", "id")
        self.value_s_hdim = g("value_s_hdim", None)
        self.value_dyn_v = g("value_dyn_v", False)
        self.end_reward = g("end_reward", True)
        n = self.adp_iter_cp.size
        v = np.array(g("adp_init_noise_cp", [self.env_init_noise]),
                     dtype=float)
        self.adp_init_noise_cp = np.pad(v, (0, n - v.size), "edge")
        self.adp_init_noise = None

    def update_adaptive_params(self, i_iter):
        super().update_adaptive_params(i_iter)
        self.adp_init_noise = _interp_schedule(self.adp_iter_cp,
                                               self.adp_init_noise_cp, i_iter)


def apply_model_params(spec: ModelSpec, cfg) -> ModelSpec:
    """set_model_params: with ``action_type: torque`` and ``j_stiff`` /
    ``j_damp`` in the config, override every hinge dof's stiffness and
    damping before the model is built.  Mutates and returns ``spec``."""
    if getattr(cfg, "action_type", "position") != "torque":
        return spec
    if getattr(cfg, "j_stiff", None) is not None:
        spec.dof_stiffness[6:] = np.asarray(cfg.j_stiff, float)
    if getattr(cfg, "j_damp", None) is not None:
        spec.dof_damping[6:] = np.asarray(cfg.j_damp, float)
    return spec


def make_env_params(cfg: EgoMimicConfig, spec: ModelSpec, obs_dim: int,
                    dtype=torch.float32, device="cpu",
                    contact: engine.ContactParams = engine.DEFAULT_CONTACT):
    """Compile the env-relevant config subset into EnvParams.

    An optional ``prep_refresh:`` config key overrides the engine's
    prep-refresh cadence (ContactParams.prep_refresh); ``1`` recomputes the
    whole prep every substep, as MuJoCo C does."""
    from ..envs.humanoid import EnvParams
    pr = getattr(cfg, "prep_refresh", None)
    if pr is not None:
        contact = contact._replace(prep_refresh=int(pr))
    ws = cfg.reward_weights
    w = np.array([ws.get("w_p", 0.5), ws.get("w_v", 0.1), ws.get("w_e", 0.2),
                  ws.get("w_rp", 0.1), ws.get("w_rv", 0.1)])
    k = np.array([ws.get("k_p", 2), ws.get("k_v", 0.005), ws.get("k_e", 20),
                  ws.get("k_rh", 300), ws.get("k_rq", 300),
                  ws.get("k_rl", 5.0), ws.get("k_ra", 0.5)])
    b_diffw = cfg.b_diffw if cfg.b_diffw is not None \
        else np.ones(spec.nbody - 1)
    arr = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(
        device=device, dtype=dtype)
    return EnvParams(
        obs_coord=cfg.obs_coord, obs_vel=cfg.obs_vel,
        obs_heading=cfg.obs_heading, obs_phase=cfg.obs_phase,
        root_deheading=cfg.root_deheading,
        env_episode_len=cfg.env_episode_len, fr_margin=cfg.fr_margin,
        env_start_first=cfg.env_start_first, action_type=cfg.action_type,
        frame_skip=15, reward_id=cfg.reward_id,
        random_cur_t=bool(getattr(cfg, "random_cur_t", False)),
        reward_decay=bool(cfg.reward_weights.get("decay", False)),
        v_ord=cfg.reward_weights.get("v_ord", 2),
        nq=spec.nq, nv=spec.ndof, nu=spec.nu, obs_dim=obs_dim,
        jkp=arr(getattr(cfg, "jkp", np.zeros(spec.nu))),
        jkd=arr(getattr(cfg, "jkd", np.zeros(spec.nu))),
        a_ref=arr(getattr(cfg, "a_ref", np.zeros(spec.nu))),
        a_scale=arr(getattr(cfg, "a_scale", np.ones(spec.nu))),
        torque_lim=arr(getattr(cfg, "torque_lim", np.ones(spec.nu))),
        env_init_noise=float(cfg.env_init_noise), w=arr(w), k=arr(k),
        b_diffw=arr(b_diffw), contact=contact)
