"""The port's data-parallel runtime (egopose_tpu_torch/parallel/) on the
CPU: gloo ranks with one torch thread each, rendezvous through a FileStore.

- 2 data-parallel ranks against one process, float64, on the JAX dry run's
  world (8 lanes, 4-step episodes, humanoid_1205_v1.xml): an ego-mimic
  sample and update on the full-batch and the minibatch PPO paths, under
  TRPO and under VGAIL, and an ego-forecast one. Rewards rtol 1e-8 / atol
  1e-10 and metrics rtol 1e-6 / atol 1e-8 (tests/test_mesh.py's bars);
  every parameter within 1e-10 after the update, but for the input weights
  that read observation column 4, held within 1e-6. That column is the z
  component of the de-headed root quaternion, a physical zero whose
  rounding noise (std ~1e-17) the filter divides by 1e-8; the filter merges
  the ranks' sums in another order than one process does, so its
  normalized inputs differ at ~1e-11, and Adam, below its epsilon, moves
  the weights reading it by up to ~1e-7;
- statereg data-parallel, 2 ranks against 1 at the JAX mesh test's
  widths, float64: the epoch loss and the parameters within 1e-8;
- a 2-rank PPO update of a fixed batch against the JAX package's
  single-device ppo_update (tests/test_torch_rl.py's case and bars);
- a rank's TCN dropout masks are its slice of the whole batch's;
- the rejections (``make_mesh(2)`` on CUDA without two cards, lanes or
  chunks that do not split over the ranks);
- the audit: ``summarize`` and ``assert_dp_pattern`` give JAX's text and
  raise on the same inventories; a recorded update moves only all-reduces
  no larger than an optimizer's parameters and gathers nothing; no module
  but parallel/mesh.py calls a torch.distributed collective; the dry run
  reports ok.

The rank bodies live in egopose_tpu_torch/parallel/dryrun.py (see
tests/test_torch_seqpar.py).
"""
import os
import re

import numpy as np
import pytest
import torch
import yaml

from egopose_tpu.parallel import audit as jaudit
from egopose_tpu.rl import ppo as jppo
from egopose_tpu_torch.convert import params_from_jax
from egopose_tpu_torch.models.video_state_net import VideoStateNet
from egopose_tpu_torch.parallel import audit, dryrun
from egopose_tpu_torch.parallel import mesh as meshlib
from egopose_tpu_torch.rl import ppo as tppo
from egopose_tpu_torch.rl.nets import PolicyGaussian, Value
from test_torch_rl import (ACT, B, FEAT, HID, MARGIN, OBS, PPO_TOL, VH,
                           _assert_same_params, _jax_update,
                           ppo_case)  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "egopose_tpu_torch")
PARAM_TOL = 1e-10        # parameters after the update
DEGENERATE_TOL = 1e-6    # input weights reading the degenerate column
DEGENERATE_STD = 1e-12   # a filter std below this is rounding noise
# The weights that read the filtered observation, by index in AgentEgo.nets
# (policy, policy context, value, value context): ego-mimic's MLPs take
# [context, observation]; ego-forecast's context nets encode the past
# observations and its MLPs read only contexts.
OBS_READERS = {False: {0: "net.layers.0.weight", 2: "net.layers.0.weight"},
               True: {1: "s_net.rnn_f.ih.weight",
                      3: "s_net.rnn_f.ih.weight"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_mesh_on_cuda_without_enough_cards_raises():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=rf"only {n} CUDA device\(s\)"):
        meshlib.make_mesh(n + 1, device="cuda")
    with pytest.raises(RuntimeError, match="only"):
        meshlib.launch(n + 1, print, device="cuda")


RUNS = {"full_batch": {}, "minibatch": {"mini_batch": 12},
        "forecast": {"forecast": True},
        "trpo": {"overrides": {"policy_objective": "trpo"}},
        "vgail": {"overrides": {"discriminator": {
            "hidden_dims": [16], "num_update": 2, "reward_weight": 0.5}}}}


@pytest.fixture(scope="module", params=sorted(RUNS))
def dp_run(request):
    """(name, one-process result, each rank's result) of one sample and
    update on 2 data-parallel ranks."""
    kw = RUNS[request.param]
    one = dryrun.train_step(**kw)
    outs = meshlib.launch(2, dryrun.train_step, 2, 1, "float64", 8, 4,
                          kw.get("forecast", False), False,
                          kw.get("mini_batch"), 1, 7, "cpu", None, False,
                          kw.get("overrides"))
    return request.param, one, outs


def _agent(forecast):
    """The dry-run world's agent (8 lanes), for its nets' shapes."""
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    from egopose_tpu_torch.rl.agent_forecast import AgentForecast
    spec, model, tables, p, expert, cnn, cfg = dryrun.world(
        torch.float64, forecast=forecast)
    cls = AgentForecast if forecast else AgentEgo
    return cls(model, spec, p, tables, expert, cnn, cfg, batch_lanes=8,
               seed=0, dtype=torch.float64)


def _net_sizes(forecast):
    """Parameter counts of the agent's four nets, in AgentEgo.nets'
    order."""
    return [sum(q.numel() for q in net.parameters())
            for net in _agent(forecast).nets]


def _degenerate_weights(forecast, zstat):
    """(the observation columns whose filter std, from ``zstat`` (n, mean,
    s), is rounding noise; a mask over the flattened parameters of the
    agent's nets that is True on the input weights reading them)."""
    from egopose_tpu_torch.ops import running_norm
    agent = _agent(forecast)
    d = agent.zstat.mean.numel()
    stat = running_norm.RunningStat(zstat[0], zstat[1:1 + d],
                                    zstat[1 + d:])
    cols = (running_norm.std(stat) < DEGENERATE_STD).nonzero().flatten()
    masks = []
    for i, net in enumerate(agent.nets):
        for pname, q in net.named_parameters():
            m = torch.zeros(q.shape, dtype=torch.bool)
            if OBS_READERS[forecast].get(i) == pname:
                # the observation is the last d inputs
                m[:, q.shape[1] - d + cols] = True
            masks.append(m.reshape(-1))
    return cols.tolist(), torch.cat(masks)


def test_dp_step_matches_one_process(dp_run):
    name, one, outs = dp_run
    assert [o["data_rank"] for o in outs] == [0, 1]
    rewards = torch.cat([o["rewards"] for o in outs], 1)
    np.testing.assert_allclose(rewards.numpy(), one["rewards"].numpy(),
                               rtol=1e-8, atol=1e-10)
    cols, degenerate = _degenerate_weights(name == "forecast", one["zstat"])
    assert cols == [4]
    for out in outs:
        np.testing.assert_allclose(out["avg_c_reward"], one["avg_c_reward"],
                                   rtol=1e-8)
        assert out["num_steps"] == one["num_steps"] == 32
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-6,
                                       atol=1e-8, err_msg=k)
        err = (out["params"] - one["params"]).abs()
        assert float(err[~degenerate].max()) <= PARAM_TOL
        assert float(err[degenerate].max()) <= DEGENERATE_TOL
    # the update moved the nets, identically on both ranks
    assert torch.equal(outs[0]["params"], outs[1]["params"])
    assert torch.equal(outs[0]["zstat"], outs[1]["zstat"])


def test_recorded_dp_update_only_all_reduces_parameters(dp_run):
    """The data-parallel contract: the update's collectives are
    all-reduces, none larger than one optimizer's parameters; the sample
    gathers nothing; neither moves a batch-sized gather."""
    name, one, outs = dp_run
    sizes = _net_sizes(name == "forecast")
    largest = max(sizes[0] + sizes[1], sizes[2] + sizes[3]) * 8
    for out in outs:
        upd, smp = out["audit_update"], out["audit_sample"]
        assert {c.kind for c in upd} == {"all-reduce"}
        assert max(c.bytes for c in upd) == largest
        assert {c.kind for c in smp} <= {"all-reduce"}
        for label, cols in (("update", upd), ("sample", smp)):
            audit.assert_dp_pattern(cols, out["batch_shard_bytes"], label)


def test_statereg_dp_matches_one_rank(tmp_path, monkeypatch):
    """state_reg's training loop, float64, 2 ranks against 1 at the JAX
    mesh test's widths (fr_num 48, v_hdim 16, cnn_fdim 12, mlp [24]): one
    epoch of the synthetic flow cut to 2 takes x 48 frames, its 2 chunks
    one batch, ResNet-18 with global BatchNorm statistics."""
    monkeypatch.setenv("EGOPOSE_SYN_LEN", "48")
    base = yaml.safe_load(open(f"{REPO}/config/statereg/subject_03.yml"))
    base.update(dict(fr_num=48, fr_margin=3, v_hdim=16, cnn_fdim=12,
                     mlp_dim=[24], num_epoch=1, save_model_interval=0,
                     seed=5))
    base.pop("meta_id", None)
    monkeypatch.chdir(tmp_path)
    one = dryrun.statereg_train(1, base, str(tmp_path), batch_chunks=2)
    outs = meshlib.launch(2, dryrun.statereg_train, 2, base, str(tmp_path),
                          "float64", 2)
    assert one["loss"] > 0
    for out in outs:
        assert abs(out["loss"] - one["loss"]) <= 1e-8 * one["loss"]
        assert float((out["params"] - one["params"]).abs().max()) <= 1e-8


def test_tcn_dropout_of_a_shard_is_the_batch_masks_slice():
    """A data-parallel rank's TCN draws its dropout masks for the whole
    batch and keeps its slice (TemporalConvNet.lanes), so a statereg rank
    trains on the one-process masks."""
    from egopose_tpu_torch.models.tcn import TemporalConvNet
    net = TemporalConvNet(5, [6, 8], 3, 0.5).double().train()
    x = torch.randn(4, 17, 5, dtype=torch.float64)
    torch.manual_seed(3)
    whole = net(x)
    torch.manual_seed(3)
    net.lanes = (4, 2)
    shard = net(x[2:])
    assert torch.equal(shard, whole[2:])
    assert not torch.equal(whole[:2], whole[2:])


def _torch_nets(trees):
    sds = params_from_jax(*trees)
    nets = [PolicyGaussian(OBS + VH, ACT, HID, "relu", -1.0),
            VideoStateNet(FEAT, VH, MARGIN), Value(OBS + VH, HID, "relu"),
            VideoStateNet(FEAT, VH, MARGIN)]
    for net, sd in zip(nets, sds):
        net.double().load_state_dict(sd)
    return nets


@pytest.mark.parametrize("mode", ["full_batch", "minibatch"])
def test_dp_update_matches_jax(ppo_case, mode):
    """2 ranks of 2 lanes each against JAX's one-device ppo_update, with
    the global-norm clip acting and AdamW (full batch) or JAX's minibatch
    permutations: tests/test_torch_rl.py's bars."""
    import jax
    trees, batch, windows = ppo_case
    hyper = jppo.PPOHyper(num_epochs=2)
    lrs = dict(policy_lr=3e-3, value_lr=1e-2)
    perms, mb, key = None, 0, None
    if mode == "full_batch":
        opt_kw = dict(lrs, grad_clip=0.05, policy_weight_decay=0.01)
    else:
        opt_kw = dict(lrs, grad_clip=40.0)
        key, mb = jax.random.PRNGKey(5), 2
        perms = np.stack([np.asarray(jax.random.permutation(ke, B))
                          for ke in jax.random.split(key, 2)])
    ts_j, m_j = _jax_update(trees, batch, windows, hyper, opt_kw, key=key,
                            mb=mb)
    outs = meshlib.launch(2, dryrun.ppo_rank, 2, _torch_nets(trees), batch,
                          windows, tppo.PPOHyper(num_epochs=2), opt_kw, mb,
                          perms)
    for out in outs:
        nets = _torch_nets(trees)
        for net, sd in zip(nets, out["state"]):
            net.load_state_dict(sd)
        _assert_same_params(nets, ts_j, PPO_TOL)
        for name in ("policy_loss", "value_loss", "n_valid", "n_exp"):
            assert abs(out["metrics"][name] - float(m_j[name])) <= PPO_TOL


class _Axes:
    """A stand-in mesh of 8 ranks on one axis: the guard raises before
    any collective."""
    axis_names = ("data",)

    def size(self, axis=None):
        return 8


def test_lanes_and_chunks_must_divide_the_ranks(tmp_path, monkeypatch):
    from egopose_tpu_torch.cli import state_reg
    from egopose_tpu_torch.rl.agent_ego import AgentEgo
    spec, model, tables, p, expert, cnn, cfg = dryrun.world(torch.float64)
    with pytest.raises(ValueError, match="divisible"):
        AgentEgo(model, spec, p, tables, expert, cnn, cfg, batch_lanes=9,
                 seed=0, dtype=torch.float64, mesh=_Axes())
    os.makedirs(tmp_path / "config")
    os.symlink(f"{REPO}/config/statereg", tmp_path / "config" / "statereg")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=re.escape(
            "--batch-chunks 4 not divisible by --dp-devices 3")):
        state_reg.main(["--cfg", "subject_03", "--synthetic", "--device",
                        "cpu", "--batch-chunks", "4", "--dp-devices", "3"])


def test_audit_summary_and_pattern_match_jax():
    """The same inventories (the JAX test's async-start case) give JAX's
    text and the same verdicts."""
    hlo = "\n".join([
        "  %ag = (f32[4,8], f32[32,8]) all-gather-start(f32[4,8] %x)",
        "  %ar = (f32[16], f32[16]) all-reduce-start(f32[16] %g)",
        "  %sync = f64[16,3] all-reduce(f64[16,3] %h), to_apply=%add",
        "  %cp = f32[2,8] collective-permute(f32[2,8] %z)",
    ])
    found_j = jaudit.collectives_of(hlo, n_devices=8)
    found = [audit.Collective(*c) for c in found_j]
    assert audit.summarize(found, "update") \
        == jaudit.summarize(found_j, "update")
    for size in (32 * 8 * 4, 32 * 8 * 4 + 1):
        outcome = []
        for fn, cols in ((audit.assert_dp_pattern, found),
                         (jaudit.assert_dp_pattern, found_j)):
            try:
                fn(cols, size, "update")
                outcome.append("ok")
            except AssertionError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]
    assert outcome[0] == "ok"
    # what mesh.py notes: kind, dtype name, result shape and ring traffic
    with audit.record() as rec:
        audit.note("all-reduce", torch.zeros(16, dtype=torch.float64), 4)
        audit.note("all-gather", torch.zeros(4, 2, 8, dtype=torch.float32),
                   4)
    assert audit.collectives_of(rec) == [
        audit.Collective("all-reduce", "f64", (16,), 128, 1.5 * 128),
        audit.Collective("all-gather", "f32", (4, 2, 8), 256, 0.75 * 256)]


def test_collectives_only_in_mesh():
    """Every collective runs through parallel/mesh.py, where the audit
    records it."""
    pat = re.compile(r"\b(all_reduce|all_gather|broadcast|reduce_scatter|"
                     r"all_to_all|send|recv|barrier|gather|scatter)"
                     r"(_object|_into_tensor|_coalesced)?\(")
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            path = os.path.join(root, f)
            if not f.endswith(".py") or path.endswith(
                    os.path.join("parallel", "mesh.py")):
                continue
            for i, line in enumerate(open(path), 1):
                if re.search(r"\bdist\.\w+\(|torch\.distributed\.\w+\(",
                             line) and pat.search(line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders


def test_dryrun_reports_ok(capsys):
    outs = dryrun.main(["2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "dryrun_multichip(2): ok" in text
    assert "collective audit [update]" in text
    assert len(outs) == 2 and all(o["sp_err"] <= 1e-5 for o in outs)


def test_dryrun_defaults_to_cuda(monkeypatch):
    """Without ``--device`` the dry run asks for CUDA, and raises where
    there is none, as the CLIs do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["2"])
