"""The port's state-regression step against the benchmark's plain reference
(benchmark/reference/plain/models/statereg_ref.py), and the step's spans,
on the CPU:

- VideoRegNet (ResNet-18, bi-LSTM, MLP, head) trained by ``train_step`` in
  float64 on seeded random weights, 32x32 flow, 2 chunks of T = 24
  frames: the CNN's features, the predictions, the loss, every gradient,
  Adam's step (the reference's, on the port's gradient) and the
  BatchNorm statistics agree with the reference's at 1e-10 of their
  scale, on the first step (Adam's state fresh) and on the second (from
  the port's state after the first);
- under ``profile.enable()``, ``state_reg.main``'s first training step
  keeps each ``statereg.*`` span of ``train_step`` once, under one
  ``statereg.step`` root; the fetch is a root beside it, the batch's
  assembly a root on the prefetch thread, the set-up's ``setup.world``
  and ``setup.nets`` once each; the frame counter counts the step's
  padded batch; ``step_hook`` runs before and after the step, outside every
  span.
"""
import os
import sys

import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.reference.plain.models import statereg_ref  # noqa: E402
from egopose_tpu_torch.cli import state_reg  # noqa: E402
from egopose_tpu_torch.models.video_reg_net import VideoRegNet  # noqa: E402
from egopose_tpu_torch.utils import profile  # noqa: E402

T, B, RES, D, MARGIN, LR = 24, 2, 32, 11, 4, 1e-3
TOL = 1e-10
SECTIONS = ("statereg.cnn_forward", "statereg.temporal_forward",
            "statereg.temporal_backward", "statereg.cnn_backward",
            "statereg.optimizer")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(gen):
    f64 = dict(generator=gen, dtype=torch.float64)
    flow = torch.randn(T, B, RES, RES, 2, **f64)
    gt = torch.randn(T - 2 * MARGIN, B, D, **f64)
    mask = torch.ones(T - 2 * MARGIN, B, dtype=torch.float64)
    mask[9:, 1] = 0.0
    return flow, gt, mask


def _state(net, opt):
    params = dict(net.named_parameters())
    adam = None
    if opt.state:
        st = [opt.state[p] for p in params.values()]
        adam = dict(step=int(st[0]["step"]),
                    exp_avg={k: s["exp_avg"].clone()
                             for k, s in zip(params, st)},
                    exp_avg_sq={k: s["exp_avg_sq"].clone()
                                for k, s in zip(params, st)})
    return ({k: p.detach().clone() for k, p in params.items()},
            {k: b.detach().clone() for k, b in net.named_buffers()}, adam)


def _close(got, want):
    scale = float(want.abs().max())
    return float((got - want).abs().max()) <= TOL * max(scale, 1e-300)


@pytest.fixture(scope="module")
def steps():
    """Two training steps of the port in float64 and, for each, the
    reference's step from the port's state before it."""
    torch.manual_seed(3)
    net = VideoRegNet(D, 128, 128, frame_shape=(RES, RES, 3)).double()
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    seen = {}
    net.cnn.register_forward_hook(
        lambda m, a, out: seen.__setitem__("feats", out.detach()))
    net.linear.register_forward_hook(
        lambda m, a, out: seen.__setitem__("pred", out.detach()))
    gen = torch.Generator().manual_seed(4)
    out = []
    for _ in range(2):
        params, buffers, adam = _state(net, opt)
        flow, gt, mask = _batch(gen)
        loss = state_reg.train_step(net, opt, flow, gt, mask, MARGIN,
                                    torch.float64)
        ref = statereg_ref.train_step(params, buffers, adam, flow, gt,
                                      mask, MARGIN, LR)
        prog = dict(feats=seen["feats"].reshape(T, B, -1),
                    pred=seen["pred"], loss=loss,
                    grads={k: p.grad.clone()
                           for k, p in net.named_parameters()},
                    params={k: p.detach().clone()
                            for k, p in net.named_parameters()},
                    buffers={k: b.clone() for k, b in net.named_buffers()},
                    before=params, buffers_before=buffers, adam=adam)
        out.append((prog, ref))
    return out


@pytest.mark.parametrize("i", [0, 1], ids=["fresh_adam", "carried_adam"])
def test_step_matches_plain_reference(steps, i):
    prog, ref = steps[i]
    assert _close(prog["feats"], ref["feats"])
    assert _close(prog["pred"], ref["pred"])
    assert _close(prog["loss"], ref["loss"])
    assert set(prog["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
        assert float(g.abs().max()) > 0, k
        assert _close(prog["grads"][k], g), k
    # Adam's step on the port's own gradient: where a gradient is near
    # Adam's epsilon the change amplifies its rounding ~1e5 times
    adam = prog["adam"]
    for k, g in prog["grads"].items():
        m, v = (adam["exp_avg"][k], adam["exp_avg_sq"][k]) if adam \
            else (torch.zeros_like(g), torch.zeros_like(g))
        want, _, _ = statereg_ref.adam(prog["before"][k], g, m, v,
                                       (adam["step"] if adam else 0) + 1, LR)
        assert _close(prog["params"][k] - prog["before"][k],
                      want - prog["before"][k]), k
    assert set(ref["buffers"]) == {
        k for k in prog["buffers"] if k.endswith(("running_mean",
                                                   "running_var"))}
    for k, b in ref["buffers"].items():
        assert _close(prog["buffers"][k] - prog["buffers_before"][k],
                      b - prog["buffers_before"][k]), k


def test_first_step_spans(tmp_path, monkeypatch):
    os.makedirs(tmp_path / "config" / "statereg")
    with open(f"{REPO}/config/statereg/subject_03.yml") as f:
        cfg = yaml.safe_load(f)
    with open(tmp_path / "config" / "statereg" / "subject_03.yml", "w") as f:
        yaml.safe_dump(cfg, f)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EGOPOSE_SYN_LEN", "60")
    calls = []

    class Stop(Exception):
        pass

    def hook(when, step, net, opt, batch, loss):
        calls.append((when, step, [s.name for s in profile.TRACER._open],
                      batch[0].shape, batch[3], loss is None))
        if when == "after":
            raise Stop

    profile.disable()
    profile.clear()
    profile.enable()
    try:
        with pytest.raises(Stop):
            state_reg.main(["--cfg", "subject_03", "--mode", "train",
                            "--synthetic", "--device", "cpu"],
                           step_hook=hook)
        spans, counts = profile.spans(), profile.counts()
    finally:
        profile.disable()
        profile.clear()
    # the default synthetic world at 60 frames: one chunk a take, 2 takes,
    # padded to fr_num + 30 frames, in a batch of 4 chunks
    assert [c[:2] for c in calls] == [("before", 0), ("after", 0)]
    assert all(c[2] == [] for c in calls)
    assert calls[0][3] == (150, 4, 32, 32, 2) and calls[0][4] == 2 * 40
    assert calls[0][5] and not calls[1][5]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (root,) = by_name["statereg.step"]
    assert root.parent is None and root.key == 0
    for name in SECTIONS:
        (s,) = by_name[name]
        assert s.parent == root.id and s.key == 0
        assert root.start <= s.start <= s.end <= root.end
    starts = [by_name[n][0].start for n in SECTIONS]
    assert starts == sorted(starts)
    (fetch,) = by_name["statereg.fetch"]
    assert fetch.parent is None and fetch.end <= root.start
    assert by_name["statereg.assemble"]
    assert all(s.parent is None for s in by_name["statereg.assemble"])
    for name in ("setup.world", "setup.nets"):
        (s,) = by_name[name]
        assert s.parent is None and s.end <= fetch.start
    assert counts == {"statereg.padded_frames": 600}
