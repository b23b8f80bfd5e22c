"""The port's native checkpoint (AgentEgo.save_native / load_native, the
counterpart of the JAX package's save_orbax / load_orbax), the float64
filter of a JAX checkpoint in a float32 eval, and the summaries of
utils/log.py, on the CPU:

- the native checkpoint round-trips the four nets, the filter and both
  optimizers (moments, counts, learning rate) exactly, and an update after
  a resume equals the uninterrupted one bitwise, under PPO and TRPO;
- a directory without the port's file raises, naming the pickle;
- a JAX-written checkpoint whose filter is float64 evaluates without
  --f64: the filter is cast to float32, and traj_pred lies within 1e-4
  (relative) of the same eval under --f64;
- to_uint8_image equals JAX's bitwise; an unknown scale raises in both;
- image and histogram write an event file whose records equal the JAX
  writer's (pixels, histogram buckets, scalars), and the JSONL fallback
  (tensorboard's import made to fail) writes JAX's records."""
import os
import sys

import numpy as np
import pytest
import torch

from egopose_tpu_torch.rl.agent_ego import AgentEgo
from test_torch_oracle import _tiny_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XML = os.path.join(REPO, "assets", "mujoco_models", "humanoid_1205_v1.xml")
B, T, M, N_TAKES, T_TAKE = 4, 6, 3, 2, 30
_LOAD = AgentEgo.load_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """subject_03 at small widths (MLPs 32, context 16), fr_margin 3,
    6-step episodes, 2 epochs; 2 takes x 30 frames of features and two
    injected batches."""
    from egopose_tpu_torch.physics.spec import parse_mjcf
    from egopose_tpu_torch.utils import config
    cfg = config.EgoMimicConfig("subject_03",
                                config_root=os.path.join(REPO, "config"))
    cfg.env_episode_len, cfg.fr_margin, cfg.num_optim_epoch = T, M, 2
    cfg.policy_hsize = cfg.value_hsize = [32]
    cfg.policy_v_hdim = cfg.value_v_hdim = 16
    spec = parse_mjcf(XML)
    p = config.make_env_params(cfg, spec, obs_dim=115, dtype=torch.float32)
    rng = np.random.RandomState(3)
    cnn = rng.randn(N_TAKES, T_TAKE, 8).astype(np.float32)

    def batch():
        from egopose_tpu_torch.rl.rollout import SegmentBatch
        f = lambda *s: torch.tensor(rng.randn(*s), dtype=torch.float32)
        return SegmentBatch(
            states=f(T, B, 115), actions=0.1 * f(T, B, 52),
            rewards=f(T, B).abs(), masks=(f(T, B) > -1).float(),
            exps=(f(T, B) > -0.5).float(), valids=torch.ones(T, B),
            reward_info=f(T, B, 5).abs(), expert_ind=torch.tensor([0, 1, 1, 0]),
            start_ind=torch.tensor([3, 8, 20, 12]), fails=torch.zeros(T, B))
    return cfg, spec, p, cnn, batch(), batch()


def _agent(world, seed, objective="ppo"):
    cfg, spec, p, cnn, _, _ = world
    cfg.policy_objective = objective
    return AgentEgo(None, spec, p, None, None, cnn, cfg, batch_lanes=B,
                    seed=seed)


def _state(agent):
    ts = agent.train_state
    return ([t for net in agent.nets for t in net.state_dict().values()]
            + list(agent.zstat), ts.opt_policy.state_dict(),
            ts.opt_value.state_dict())


def _assert_equal_state(a, b):
    tensors_a, *opts_a = _state(a)
    tensors_b, *opts_b = _state(b)
    assert all(torch.equal(x, y) for x, y in zip(tensors_a, tensors_b))
    for oa, ob in zip(opts_a, opts_b):
        assert oa["lr"] == ob["lr"]
        for key in ("mu", "nu"):
            assert all(torch.equal(x, y) for x, y in zip(oa[key], ob[key]))
        for key in ("count", "notfinite_count", "total_notfinite"):
            assert torch.equal(oa[key], ob[key]), key


@pytest.mark.parametrize("objective", ["ppo", "trpo"])
def test_native_checkpoint_resumes_exactly(world, tmp_path, objective):
    from egopose_tpu_torch.ops import running_norm
    from egopose_tpu_torch.rl.agent_ego import NATIVE_FILE
    *_, batch1, batch2 = world
    writer = _agent(world, 1, objective)
    writer.update_params(batch1)
    writer.set_policy_lr(1.25e-4)
    writer.zstat = running_norm.push_batch(writer.zstat,
                                           batch1.states.reshape(-1, 115))
    path = tmp_path / "models" / "iter_0001.orbax"
    writer.save_native(str(path))
    writer.save_native(str(path))                # over an existing one
    assert os.listdir(path) == [NATIVE_FILE]
    assert os.listdir(path.parent) == ["iter_0001.orbax"]   # no leftovers

    reader = _agent(world, 2, objective)
    assert not torch.equal(reader.policy_net.action_mean.weight,
                           writer.policy_net.action_mean.weight)
    reader.load_native(str(path))
    _assert_equal_state(reader, writer)
    assert int(reader.train_state.opt_value.count) > 0
    assert reader.train_state.opt_policy.lr == 1.25e-4

    m_w, m_r = writer.update_params(batch2), reader.update_params(batch2)
    assert m_w == m_r
    _assert_equal_state(reader, writer)


def test_native_load_refuses_other_directories(world, tmp_path):
    path = tmp_path / "iter_0001.orbax"
    os.makedirs(path)
    (path / "_METADATA").write_text("{}")        # what orbax writes
    with pytest.raises(FileNotFoundError, match=r"iter_%04d\.p"):
        _agent(world, 1).load_native(str(path))


def _eval(root, extra, monkeypatch):
    """The port's ego_mimic_eval on tests/test_torch_oracle.py's tiny world
    (2 synthetic takes x 40 frames), and the filter's dtype after the
    checkpoint loaded."""
    from egopose_tpu_torch.cli import ego_mimic_eval
    seen = {}

    def load(self, cp):
        _LOAD(self, cp)
        seen["filter"] = {x.dtype for x in self.zstat}
        seen["nets"] = {t.dtype for n in self.nets
                        for t in n.state_dict().values()}
    monkeypatch.chdir(root)
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_TAKES", "2")
    monkeypatch.setenv("EGOPOSE_SYNTHETIC_LEN", "40")
    monkeypatch.setattr(AgentEgo, "load_checkpoint", load)
    res, _ = ego_mimic_eval.main(["--cfg", "tiny_xe", "--iter", "0",
                                  "--synthetic", "--device", "cpu"] + extra)
    return res, seen


def test_float64_jax_checkpoint_evaluates_in_float32(tmp_path, monkeypatch):
    from egopose_tpu_torch.convert import load_checkpoint_pickle
    root = str(tmp_path)
    _tiny_world(root)
    cp = load_checkpoint_pickle(os.path.join(
        root, "results", "egomimic", "tiny_xe", "models", "iter_0000.p"))
    assert {np.asarray(x).dtype for x in cp["running_state"]} \
        == {np.dtype(np.float64)}
    f32, seen32 = _eval(root, [], monkeypatch)
    f64, seen64 = _eval(root, ["--f64"], monkeypatch)
    assert seen32 == {"filter": {torch.float32}, "nets": {torch.float32}}
    assert seen64 == {"filter": {torch.float64}, "nets": {torch.float64}}
    for take, want in f64["traj_pred"].items():
        got = f32["traj_pred"][take]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_float32_filter_stays_float32_under_f64(world):
    """The other direction keeps the stored dtype, as the JAX eval does
    (tests/test_torch_eval.py holds 1e-6 on it)."""
    cfg, spec, p, cnn, _, _ = world
    cp = _agent(world, 1).checkpoint()
    agent = AgentEgo(None, spec, p, None, None, cnn, cfg, batch_lanes=B,
                     dtype=torch.float64)
    agent.load_checkpoint(cp)
    assert {x.dtype for x in agent.zstat} == {torch.float32}
    assert agent.policy_net.action_mean.weight.dtype == torch.float64


# ---------------------------------------------------------------------------
# utils/log.py: images, histograms, the JSONL fallback
# ---------------------------------------------------------------------------

def _images():
    rng = np.random.RandomState(0)
    unit = rng.rand(6, 5, 3) * 1.4 - 0.2
    unit[0, 0, 0] = np.nan
    return {"uint8": ((rng.rand(6, 5, 3) * 255).astype(np.uint8), None),
            "unit": (unit, None), "unit_named": (unit, "unit"),
            "byte": (rng.rand(6, 5, 3) * 300 - 20, "byte"),
            "gray": (rng.rand(6, 5), None)}


@pytest.mark.parametrize("case", sorted(_images()))
def test_to_uint8_image_matches_jax(case):
    from egopose_tpu.utils.log import to_uint8_image as jto
    from egopose_tpu_torch.utils.log import to_uint8_image
    img, scale = _images()[case]
    got = to_uint8_image(img, scale)
    want = jto(img, scale)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if case == "uint8":
        assert got is img
    with pytest.raises(ValueError, match="scale"):
        to_uint8_image(np.zeros((2, 2, 3)), "bogus")
    with pytest.raises(ValueError, match="scale"):
        jto(np.zeros((2, 2, 3)), "bogus")


def _summaries(writer):
    rng = np.random.RandomState(1)
    writer.scalar("loss", 1.5, 0)
    writer.image("frame", (rng.rand(8, 6, 3) * 255).astype(np.uint8), 1)
    writer.image("flow", rng.randn(4, 5, 3), 2)
    writer.image("bytes", rng.rand(4, 4, 3) * 255, 2, scale="byte")
    writer.histogram("weights", rng.randn(500), 3)
    writer.histogram("empty", np.array([]), 3)
    writer.histogram("nans", np.full(5, np.nan), 3)
    writer.flush()


def _events(logdir):
    """(tag, step, kind, payload) of every summary value in ``logdir``'s
    event file; images decoded to pixels."""
    import io
    from PIL import Image
    from tensorboard.backend.event_processing.event_file_loader import \
        RawEventFileLoader
    from tensorboard.compat.proto.event_pb2 import Event
    files = [f for f in os.listdir(logdir) if "tfevents" in f]
    assert len(files) == 1 and os.path.getsize(os.path.join(
        logdir, files[0])) > 100
    out = []
    for raw in RawEventFileLoader(os.path.join(logdir, files[0])).Load():
        ev = Event.FromString(raw)
        for v in ev.summary.value:
            kind = v.WhichOneof("value")
            if kind == "image":
                img = np.asarray(Image.open(io.BytesIO(
                    v.image.encoded_image_string)))
                payload = (v.image.height, v.image.width,
                           v.image.colorspace, img.tolist())
            elif kind == "histo":
                h = v.histo
                payload = (h.min, h.max, h.num, h.sum, h.sum_squares,
                           list(h.bucket_limit), list(h.bucket))
            else:
                payload = v.simple_value
            out.append((v.tag, ev.step, kind, payload))
    return out


def test_event_file_matches_jax(tmp_path):
    from egopose_tpu.utils.log import ScalarWriter as JWriter
    from egopose_tpu_torch.utils.log import ScalarWriter
    for cls, sub in ((ScalarWriter, "port"), (JWriter, "jax")):
        w = cls(str(tmp_path / sub))
        _summaries(w)
        if sub == "port":
            w.close()
    got, want = _events(tmp_path / "port"), _events(tmp_path / "jax")
    assert [(t, k) for t, _, k, _ in got] == [
        ("loss", "simple_value"), ("frame", "image"), ("flow", "image"),
        ("bytes", "image"), ("weights", "histo")]
    assert got == want


def test_jsonl_fallback_matches_jax(tmp_path, monkeypatch):
    import json
    from egopose_tpu.utils.log import ScalarWriter as JWriter
    from egopose_tpu_torch.utils.log import ScalarWriter
    for mod in ("tensorboard.summary.writer.event_file_writer",
                "tensorboard.compat.proto.event_pb2",
                "tensorboard.compat.proto.summary_pb2"):
        monkeypatch.setitem(sys.modules, mod, None)
    records = {}
    for cls, sub in ((ScalarWriter, "port"), (JWriter, "jax")):
        w = cls(str(tmp_path / sub))
        _summaries(w)
        assert os.listdir(tmp_path / sub) == ["scalars.jsonl"]
        with open(tmp_path / sub / "scalars.jsonl") as f:
            records[sub] = [{k: v for k, v in json.loads(line).items()
                             if k != "ts"} for line in f]
    assert len(records["port"]) == 5
    assert records["port"] == records["jax"]
