"""Multi-rank dry run of the parallel runtime (counterpart of the JAX
package's ``_dryrun_multichip_impl`` in __graft_entry__.py), and the rank
bodies that the tests and chip_smoke.py launch.

    python -m egopose_tpu_torch.parallel.dryrun N [--device cuda|cpu]

runs, in N ranks (on CUDA unless ``--device cpu`` is given; without CUDA
it raises): a data-parallel sample and update of ego-mimic (float32,
2 lanes a rank, 5-step episodes); the audit of both, every collective
inventoried (parallel/audit.py) and held to the data-parallel pattern
against one rank's shard of the largest batch tensor; the time-sharded
context encode against the unsharded one (max-abs <= 1e-5); and, for N >=
4, a step on an (N/2 x 2) data x time mesh with TCN context nets.  It
prints each audit and ``dryrun_multichip(N): ok, ...``.  CPU ranks run
under gloo; on CUDA the ranks share card 0 (gloo, staged through host
memory): the dry run checks the code path and the collectives, not a
speed-up.

A spawned rank imports the module of the function it runs, so the rank
bodies live here, in the package: a test module imports JAX, and a rank
that imported it would load JAX for nothing.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from . import audit
from . import mesh as meshlib

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
TCN_CTX = {"size": [64, 128], "dropout": 0.0}


def _config(workload: str, name: str, **overrides):
    import yaml
    from ..utils import config
    with open(os.path.join(REPO, "config", workload, name + ".yml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(overrides)
    cfg.pop("meta_id", None)
    cls = config.EgoMimicConfig if workload == "egomimic" \
        else config.EgoForecastConfig
    return cls(cfg_dict=cfg, config_root=os.path.join(REPO, "config"))


def world(dtype, episode_len: int = 4, device="cpu", forecast=False,
          tcn=False, full=False):
    """(spec, model, tables, params, expert, cnn_feat, cfg): the JAX
    package's dry-run world (subject_03 on humanoid_1205_v1.xml, 2
    synthetic takes, 32 random features a frame, 2 optimizer epochs), or
    with ``forecast`` its forecast mesh test's (egoforecast subject_03,
    fr_margin 5, takes of 48 frames, 12 features), or with ``full`` the
    training CLI's synthetic world (cli/ego_mimic.py build_world on
    config/egomimic/subject_03.yml unchanged but for the episode length:
    4 takes x 400 frames, 64 features a frame, 10 optimizer epochs).
    ``tcn``: TCN context nets (size [64, 128], no dropout)."""
    from .. import envs
    from ..physics.model import build_model
    from ..physics.spec import parse_mjcf
    from ..utils.config import make_env_params
    if full:
        from ..cli.ego_mimic import build_world
        cfg = _config("egomimic", "subject_03", env_episode_len=episode_len)
        return (*build_world(cfg, dtype, device, synthetic=True,
                             synthetic_takes=4, synthetic_len=400), cfg)
    if forecast:
        cfg = _config("egoforecast", "subject_03",
                      env_episode_len=episode_len, num_optim_epoch=1,
                      fr_margin=5)
        t_len, feat = 48, 12
    else:
        cfg = _config("egomimic", "subject_03", env_episode_len=episode_len,
                      num_optim_epoch=2)
        t_len, feat = max(4 * episode_len, 64), 32
    if tcn:
        for who in ("policy", "value"):
            setattr(cfg, f"{who}_v_net", "tcn")
            setattr(cfg, f"{who}_v_net_param", dict(TCN_CTX))
    spec = parse_mjcf(XML)
    model = build_model(spec, dtype=dtype, device=device)
    tables = envs.make_body_tables(spec, device)
    p = make_env_params(cfg, spec, obs_dim=115, dtype=dtype, device=device)
    expert = envs.synthetic_experts(model, p, tables, spec, n_takes=2,
                                    t_len=t_len, seed=0)
    expert = type(expert)(*[x.to(dtype) if x.is_floating_point() else x
                            for x in expert])
    rng = np.random.RandomState(0)
    cnn_feat = rng.randn(2, int(expert.qpos.shape[1]), feat)
    if not forecast:
        cnn_feat = cnn_feat.astype(np.float32)
    return spec, model, tables, p, expert, cnn_feat, cfg


def rank_mesh(dp: int, sp: int, device, device_ids=None):
    """This rank's mesh (dp x sp, or 1-D when ``sp`` is 1), or None
    outside ranks."""
    if not dist.is_initialized():
        return None
    if sp > 1:
        return meshlib.make_mesh_2d(dp, sp, device=device,
                                    device_ids=device_ids)
    return meshlib.make_mesh(dp, device=device, device_ids=device_ids)


def train_step(dp: int = 1, sp: int = 1, dtype: str = "float64",
               lanes: int = 8, episode_len: int = 4, forecast=False,
               tcn=False, mini_batch=None, segments: int = 1, key: int = 7,
               device="cpu", device_ids=None, first_step=False,
               overrides: dict | None = None, full=False):
    """One sample of ``segments`` segments and one update of ego-mimic (or
    ego-forecast) on this rank's share of ``lanes`` lanes (all of them
    outside ranks), in ``world``'s world (``full``: the training CLI's),
    the config's keys ``overrides`` replaced (a ``discriminator`` block
    trains with VGAIL). Returns this rank's
    rewards, the sample log's average reward, the update's metrics, every
    parameter after the update (flattened), both audits, the K5 launches
    of the world's build and the K1 launches of the sample, the sample and
    update seconds, and with ``first_step`` the first control step's qpos
    and qvel."""
    from .. import envs
    from ..physics import fk, substep
    from ..rl.agent_ego import AgentEgo
    from ..rl.agent_forecast import AgentForecast
    from ..rl.vgail import AgentVGAIL
    dt = getattr(torch, dtype)
    mesh = rank_mesh(dp, sp, device, device_ids)
    dev = mesh.device if mesh is not None else torch.device(device)
    k5 = fk.launches
    spec, model, tables, p, expert, cnn_feat, cfg = world(
        dt, episode_len, dev, forecast=forecast, tcn=tcn, full=full)
    k5 = fk.launches - k5
    if mini_batch:
        cfg.mini_batch_size = mini_batch
    for k, v in (overrides or {}).items():
        setattr(cfg, k, v)
    cls = AgentForecast if forecast else \
        AgentVGAIL if getattr(cfg, "discriminator", None) else AgentEgo
    agent = cls(model, spec, p, tables, expert, cnn_feat, cfg,
                batch_lanes=lanes, seed=0, dtype=dt, device=dev, mesh=mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(key)
    step, first = envs.step, []

    def recording_step(*args, **kw):
        out = step(*args, **kw)
        if not first:
            first.append((out[0].qpos.clone(), out[0].qvel.clone()))
        return out

    if first_step:
        envs.step = recording_step
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    try:
        k1 = substep.launches
        sync()
        t0 = time.time()
        with audit.record() as rec_sample:
            batch, log = agent.sample(gen, segments * lanes * episode_len)
        sync()
        t_sample = time.time() - t0
        k1 = substep.launches - k1
        t0 = time.time()
        with audit.record() as rec_update:
            metrics = agent.update_params(batch)
        sync()
        t_update = time.time() - t0
    finally:
        envs.step = step
    out = dict(
        data_rank=0 if mesh is None else mesh.rank(mesh.axis_names[0]),
        time_rank=0 if mesh is None or sp == 1 else mesh.rank("time"),
        rewards=batch.rewards, avg_c_reward=log.avg_c_reward,
        num_steps=log.num_steps, metrics=metrics,
        params=torch.cat([q.detach().reshape(-1) for net in agent.nets
                          for q in net.parameters()]),
        zstat=torch.cat([agent.zstat.n.reshape(1), agent.zstat.mean,
                         agent.zstat.s]),
        audit_sample=audit.collectives_of(rec_sample),
        audit_update=audit.collectives_of(rec_update),
        batch_shard_bytes=max(x.numel() * x.element_size() for x in batch),
        k1=k1, k5=k5, T_sample=t_sample, T_update=t_update)
    if first_step:
        out["first_qpos"], out["first_qvel"] = first[0]
    return meshlib.to_cpu(out)


def ppo_rank(dp: int, nets, batch: dict, windows, hyper, opt_kw: dict,
             mini_batch_lanes: int = 0, perms=None):
    """rl/ppo.py's update of the four ``nets`` (policy, policy context,
    value, value context) on ``batch`` (a SegmentBatch's fields) and
    ``windows``, this rank holding its share of the lanes (all of them
    outside ranks).  Returns the nets' state_dicts and the metrics."""
    from ..rl import ppo
    from ..rl.rollout import SegmentBatch
    mesh = rank_mesh(dp, 1, "cpu")
    opt_p, opt_v = ppo.make_optimizers(
        [*nets[0].parameters(), *nets[1].parameters()],
        [*nets[2].parameters(), *nets[3].parameters()], **opt_kw)
    ts = ppo.TrainState(*nets, opt_policy=opt_p, opt_value=opt_v)
    b = SegmentBatch(**{k: torch.as_tensor(v) for k, v in batch.items()})
    windows = torch.as_tensor(windows)
    if mesh is not None:
        b = SegmentBatch(*[meshlib.lane_slice(mesh, x, dim=1 if x.dim() > 1
                                              else 0)
                           for x in b])
        windows = meshlib.lane_slice(mesh, windows)
    _, metrics = ppo.ppo_update(ts, hyper, b, windows, mini_batch_lanes,
                                perms, mesh=mesh)
    return dict(state=[net.state_dict() for net in nets],
                metrics={k: float(v) for k, v in metrics.items()})


def sp_apply(kind: str, n: int, kwargs: dict, state: dict, x, dtype,
             causal_encode=False, grad_weights=None, device="cpu",
             device_ids=None):
    """A VideoStateNet (``kind`` "vsnet") or VideoRegNet ("vregnet") built
    from ``kwargs`` with the weights ``state``, applied to ``x`` time-
    sharded over ``n`` ranks (unsharded outside ranks).  With
    ``grad_weights`` also the gradient of sum(out * grad_weights) with
    respect to the net's parameters, summed over the ranks."""
    from ..models.video_reg_net import VideoRegNet
    from ..models.video_state_net import VideoStateNet
    from . import seqpar
    mesh = rank_mesh(n, 1, device, device_ids)
    dev = mesh.device if mesh is not None else torch.device(device)
    net = (VideoStateNet if kind == "vsnet" else VideoRegNet)(**kwargs)
    net.to(device=dev, dtype=dtype).eval()
    net.load_state_dict(state)
    x = torch.as_tensor(x).to(device=dev, dtype=dtype)
    with torch.set_grad_enabled(grad_weights is not None):
        if mesh is None:
            out = net.causal_encode(x) if causal_encode else net(x)
        elif kind == "vsnet":
            out = seqpar.vsnet_encode_sp(mesh, net, x)
        else:
            out = seqpar.vregnet_apply_sp(mesh, net, x)
    if grad_weights is None:
        return dict(out=out.cpu())
    params = list(net.parameters())
    gw = torch.as_tensor(grad_weights).to(device=dev, dtype=dtype)
    grads = torch.autograd.grad((out * gw).sum(), params)
    flat = torch.cat([g.reshape(-1) for g in grads])
    if mesh is not None:
        flat = meshlib.all_reduce_sum(mesh, flat, "data")
    return dict(out=out.detach().cpu(), grad=flat.cpu())


def statereg_train(dp: int, cfg_dict: dict, workdir: str, dtype="float64",
                   batch_chunks: int = 4, epochs: int = 1,
                   device="cpu"):
    """state_reg's training loop (cli/state_reg.py ``_train``) on the
    synthetic flow in ``workdir``, this rank holding its share of each
    batch's chunks (all of them outside ranks), in ``dtype``.  Returns
    the last epoch's loss and the net's parameters (flattened)."""
    from ..cli import state_reg
    from ..data.dataset import Dataset
    from ..utils.config import StateRegConfig
    from ..utils.log import create_logger
    os.chdir(workdir)
    mesh = rank_mesh(dp, 1, device)
    dev = mesh.device if mesh is not None else torch.device(device)
    dt = getattr(torch, dtype)
    cfg = StateRegConfig("tiny", cfg_dict=cfg_dict)
    dataset = Dataset(cfg.meta_id, "train", cfg.fr_num, cfg.iter_method,
                      cfg.shuffle, 2 * cfg.fr_margin, cfg.num_sample,
                      synthetic=True, seed=cfg.seed)
    state_dim = dataset.traj_dim
    frame_shape = dataset.load_of(0, 0, 1).shape[1:3] + (3,)
    net = state_reg.make_net(cfg, state_dim, False, frame_shape,
                             cfg.seed).to(device=dev, dtype=dt)
    args = argparse.Namespace(batch_chunks=batch_chunks, transfer_dtype="f32",
                              data_on_device=False, max_epoch=epochs, iter=0,
                              profile_dir=None)
    losses = []
    state_reg._train(args, cfg, net, dataset, state_dim, dev, dt,
                     np.float64 if dt == torch.float64 else np.float32,
                     create_logger(), None,
                     lambda *a: losses.append(a[3]), mesh=mesh)
    return dict(loss=losses[-1], params=torch.cat(
        [q.detach().reshape(-1) for q in net.parameters()]).cpu())


# -- the dry run ----------------------------------------------------------

def dryrun_rank(n: int, device, device_ids):
    """The dry run's body in each of ``n`` ranks: its audit text and
    checks (module docstring)."""
    from ..models.video_state_net import VideoStateNet
    from . import seqpar
    lines = []
    out = train_step(n, 1, "float32", 2 * n, 5, device=device,
                     device_ids=device_ids, key=0)
    loss = out["metrics"]["policy_loss"]
    assert np.isfinite(loss), f"multichip dry run produced {loss}"
    for label in ("update", "sample"):
        cols = out["audit_" + label]
        msg, _total = audit.summarize(cols, label)
        lines.append(msg)
        audit.assert_dp_pattern(cols, out["batch_shard_bytes"], label)
    mesh = rank_mesh(n, 1, device, device_ids)
    vs = VideoStateNet(16, 24, 5, "tcn", False,
                       {"size": [16, 24], "dropout": 0.0})
    vs.to(device=mesh.device, dtype=torch.float32).eval()
    meshlib.replicate(mesh, vs)
    w = torch.as_tensor(np.random.RandomState(0).randn(2, 16 * n, 16),
                        dtype=torch.float32, device=mesh.device)
    with torch.no_grad():
        err = float((seqpar.vsnet_encode_sp(mesh, vs, w) - vs(w)).abs()
                    .max())
    assert err <= 1e-5, \
        "sequence-parallel context encode diverged from the unsharded pass"
    sp_msg = ""
    if n >= 4 and n % 2 == 0:
        out2 = train_step(n // 2, 2, "float32", n, 4, tcn=True,
                          device=device, device_ids=device_ids, key=1)
        l2 = out2["metrics"]["policy_loss"]
        assert np.isfinite(l2), f"dp x sp dry run produced {l2}"
        sp_msg = f", dp x sp 2-D mesh step ok (loss {l2:.4f})"
    return dict(lines=lines, loss=loss, sp_err=err, sp_msg=sp_msg,
                k1=out["k1"] + (out2["k1"] if sp_msg else 0),
                k5=out["k5"] + (out2["k5"] if sp_msg else 0))


def dryrun(n: int, device=None) -> list:
    """Run the dry run in ``n`` ranks on ``device`` (CUDA unless named;
    the ranks share card 0), print its audits and its ok line; returns
    each rank's record."""
    device = str(resolve_device(device))
    device_ids = [0] * n if torch.device(device).type == "cuda" else None
    outs = meshlib.launch(n, dryrun_rank, n, device, device_ids,
                          device=device, device_ids=device_ids)
    lead = outs[0]
    for line in lead["lines"]:
        print(line)
    print(f"dryrun_multichip({n}): ok, policy_loss={lead['loss']:.4f}, "
          f"lanes sharded over {n} ranks ({device}), sp context encode "
          f"verified (max-abs {lead['sp_err']:.1e})" + lead["sp_msg"],
          flush=True)
    return outs


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("n", type=int)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    return dryrun(args.n, args.device)


if __name__ == "__main__":
    main()
