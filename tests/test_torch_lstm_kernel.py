"""The LSTM's time loop, K6 (csrc/lstm.cu through ops/lstm.py), against the
plain loop of cells (models/rnn.py's ``RNN.loop``): outputs and the
gradients of x, W_ih, W_hh, b_ih and b_hh, both directions, with and
without autograd, and under torch.func's grad, vjp and jvp.  The tests
marked ``cuda`` need an NVIDIA GPU and nvcc and skip without them (the
kernels have no CPU mode); the others run on the CPU and hold the dispatch
and the wrapper's refusals.  Imports no JAX, so it runs on a machine that
has only the port:

    python -m pytest tests/test_torch_lstm_kernel.py --noconftest -q

(--noconftest: the suite's conftest imports JAX, which a machine with only
the port may lack.)
"""
import pytest
import torch
from torch.func import functional_call, grad, jvp, vjp

from egopose_tpu_torch.models import rnn as rnn_mod
from egopose_tpu_torch.models.rnn import RNN
from egopose_tpu_torch.ops import lstm

# float32 against the loop: |h| < 1 rounds at ~6e-8 a step; a gradient sums
# up to T x B = 153,600 products in another order (one matmul against the
# loop's per-step ones), so it is held relative to its largest entry
F32_OUT, F32_GRAD = 1e-5, 1e-4
F64_OUT, F64_GRAD = 1e-12, 1e-12


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _net(d_in, out, bi, dtype, device, seed=0):
    torch.manual_seed(seed)
    return RNN(d_in, out, bi_dir=bi).to(dtype=dtype, device=device)


def _loop(net, x):
    """The plain loop of cells, whatever the device."""
    out = net.loop(net.rnn_f, x, False)
    if net.bi_dir:
        out = torch.cat([out, net.loop(net.rnn_b, x, True)], -1)
    return out


def _grads(net, x, fn, r):
    """(output, gradients of x and every parameter) of sum(fn(x) * r)."""
    net.zero_grad()
    x = x.detach().requires_grad_(True)
    out = fn(x)
    (out * r).sum().backward()
    return out.detach(), {"x": x.grad, **{
        n: p.grad.clone() for n, p in net.named_parameters()
        if p.grad is not None}}


def _compare(got, want, out_tol, grad_tol):
    (y, g), (y0, g0) = got, want
    assert g.keys() == g0.keys()
    errs = {"y": float((y - y0).abs().max())}
    # W_hh's gradient is exactly zero at T 1 (the carry before is zero)
    errs.update({k: float((g[k] - g0[k]).abs().max())
                 / max(float(g0[k].abs().max()), 1e-300) for k in g0})
    assert errs["y"] <= out_tol, errs
    assert max(v for k, v in errs.items() if k != "y") <= grad_tol, errs
    return errs


# ---------------------------------------------------------------------------
# the CPU: the dispatch, the plain versions and the autograd glue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bi", [True, False])
def test_rnn_on_cpu_runs_the_loop(bi, monkeypatch):
    net = _net(6, 10, bi, torch.float64, "cpu")
    calls = []
    cell = rnn_mod.LSTMCell.forward
    monkeypatch.setattr(rnn_mod.LSTMCell, "forward",
                        lambda self, *a: calls.append(1) or cell(self, *a))
    before = lstm.launches
    x = torch.randn(7, 3, 6, dtype=torch.float64)
    out = net(x)
    assert out.shape == (7, 3, 10)
    assert len(calls) == 7 * (2 if bi else 1)
    assert lstm.launches == before


TRANSFORMS = ("grad", "vjp", "jvp")


def _under(transform, net, x, r):
    """(output, derivative) of net(x) under a torch.func transform: the
    gradients of sum(net(x) * r) by the parameters and x (grad, vjp), or
    the output's tangent along seeded directions of both (jvp)."""
    params = {k: v.detach() for k, v in net.named_parameters()}
    f = lambda p, v: functional_call(net, p, (v,))
    if transform == "grad":
        def loss(p, v):
            y = f(p, v)
            return (y * r).sum(), y
        g, y = grad(loss, argnums=(0, 1), has_aux=True)(params, x)
        return y, g
    if transform == "vjp":
        y, fn = vjp(f, params, x)
        return y, fn(r)
    gen = torch.Generator().manual_seed(7)    # the same draws on any device
    tangents = ({k: torch.randn(v.shape, generator=gen, dtype=v.dtype)
                 .to(v.device) for k, v in params.items()},
                torch.randn(x.shape, generator=gen, dtype=x.dtype)
                .to(x.device))
    return jvp(f, (params, x), tangents)


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for v in items for t in _flat(v)]


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_rnn_under_torch_func_on_cpu_runs_the_loop(transform):
    """TRPO's transforms on a CPU tensor: the loop of cells, no launch."""
    net = _net(6, 10, True, torch.float64, "cpu")
    x = torch.randn(5, 2, 6, dtype=torch.float64)
    r = torch.randn(5, 2, 10, dtype=torch.float64)
    before = lstm.launches
    y, d = _under(transform, net, x, r)
    assert lstm.launches == before
    torch.testing.assert_close(y, _loop(net, x), rtol=0, atol=0)
    assert all(torch.isfinite(t).all() for t in _flat(d))


def test_recurrence_on_cpu_raises():
    """No plain copy of the recurrence beside the loop: the kernels' path
    refuses a CPU tensor."""
    net = _net(4, 6, True, torch.float64, "cpu")
    with pytest.raises(ValueError):
        net.recurrence(torch.zeros(5, 2, 4, dtype=torch.float64),
                       (net.rnn_f, net.rnn_b), (False, True))


@pytest.mark.parametrize("what", ["cpu", "f16", "hid", "ndir", "width"])
def test_kernel_wrapper_refuses_what_it_does_not_take(what):
    xg, wt, rev = torch.zeros(3, 2, 4 * 8), torch.zeros(1, 8, 4 * 8), (False,)
    if what == "f16":
        xg, wt = xg.half(), wt.half()
    elif what == "hid":
        xg, wt = torch.zeros(3, 2, 4 * 300), torch.zeros(1, 300, 4 * 300)
    elif what == "ndir":
        rev = (False, True)
    elif what == "width":
        xg = torch.zeros(3, 2, 4 * 8 + 1)
    with pytest.raises(ValueError):
        lstm.forward_cuda(xg, wt, rev, keep=False)


# ---------------------------------------------------------------------------
# the card: K6 against the loop
# ---------------------------------------------------------------------------

SHAPES = [(t, b) for b in (1, 4, 1024) for t in (1, 70, 150)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bi,hid", [(True, 64), (False, 128)])
@pytest.mark.parametrize("t_len,bsz", SHAPES)
def test_k6_matches_the_loop_with_autograd(card, t_len, bsz, bi, hid, dtype):
    """H 64 both ways (the statereg and ego-mimic context nets) and H 128
    one way (the forecast's), outputs and every gradient."""
    d_in = 128
    net = _net(d_in, 2 * hid if bi else hid, bi, dtype, card, seed=bsz)
    g = torch.Generator(device=card).manual_seed(t_len)
    x = torch.randn(t_len, bsz, d_in, generator=g, dtype=dtype, device=card)
    r = torch.randn(t_len, bsz, 2 * hid if bi else hid, generator=g,
                    dtype=dtype, device=card)
    before = lstm.launches
    got = _grads(net, x, net, r)
    assert lstm.launches == before + 2          # one forward, one backward
    want = _grads(net, x, lambda v: _loop(net, v), r)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all()
    if dtype == torch.float64:
        _compare(got, want, F64_OUT, F64_GRAD)
    else:
        _compare(got, want, F32_OUT, F32_GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("reverse", [False, True])
def test_k6_one_direction_each_way(card, reverse, dtype):
    """scan_dir's single direction, forward and reversed, H 64."""
    net = _net(32, 128, True, dtype, card, seed=3)
    cell = net.rnn_b if reverse else net.rnn_f
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(70, 4, 32, generator=g, dtype=dtype, device=card)
    r = torch.randn(70, 4, 64, generator=g, dtype=dtype, device=card)
    got = _grads(net, x, lambda v: net.scan_dir(cell, v, reverse), r)
    want = _grads(net, x, lambda v: net.loop(cell, v, reverse), r)
    torch.cuda.synchronize()
    tol = (F64_OUT, F64_GRAD) if dtype == torch.float64 \
        else (F32_OUT, F32_GRAD)
    _compare(got, want, *tol)


@pytest.mark.cuda
@pytest.mark.parametrize("bi,hid", [(True, 64), (False, 128)])
@pytest.mark.parametrize("t_len,bsz", [(150, 4), (70, 1024)])
def test_k6_under_no_grad(card, t_len, bsz, bi, hid):
    """No autograd: one forward launch a pass of both directions, nothing
    kept, the loop's outputs."""
    net = _net(64, 2 * hid if bi else hid, bi, torch.float64, card)
    x = torch.randn(t_len, bsz, 64, dtype=torch.float64, device=card)
    before = lstm.launches
    with torch.no_grad():
        y = net(x)
        want = _loop(net, x)
    assert lstm.launches == before + 1
    assert y.grad_fn is None
    assert float((y - want).abs().max()) <= F64_OUT


@pytest.mark.cuda
def test_k6_context_nets_and_causal_encode(card):
    """VideoStateNet's window pass and causal_encode (the eval's set-up) on
    the card against the same net on the CPU, float64."""
    from egopose_tpu_torch.models.video_state_net import VideoStateNet
    torch.manual_seed(0)
    net = VideoStateNet(16, 128, v_margin=10).double()
    feats = torch.randn(3, 90, 16, dtype=torch.float64)
    want = (net(feats), net.causal_encode(feats))
    net.to(card)
    before = lstm.launches
    got = (net(feats.to(card)), net.causal_encode(feats.to(card)))
    assert lstm.launches == before + 3   # the window pass, then both scans
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= F64_OUT


@pytest.mark.cuda
def test_k6_refuses_what_it_does_not_take(card):
    net = _net(8, 600, False, torch.float32, card)     # H 600 > 256
    with pytest.raises(ValueError):
        net(torch.zeros(3, 2, 8, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("transform", TRANSFORMS)
@pytest.mark.parametrize("bi,hid,t_len", [(True, 64, 70), (False, 128, 30)])
def test_k6_under_torch_func(card, transform, bi, hid, t_len):
    """TRPO's transforms through K6 (grad and vjp: forward and backward
    kernels; jvp: forward and tangent kernels) against the loop of cells
    on the CPU, float64: outputs and every derivative."""
    net = _net(16, 2 * hid if bi else hid, bi, torch.float64, "cpu")
    x = torch.randn(t_len, 4, 16, dtype=torch.float64)
    r = torch.randn(t_len, 4, 2 * hid if bi else hid, dtype=torch.float64)
    want = _under(transform, net, x, r)
    net.to(card)
    before = lstm.launches
    got = _under(transform, net, x.to(card), r.to(card))
    assert lstm.launches == before + 2
    assert float((got[0].cpu() - want[0]).abs().max()) <= F64_OUT
    for a, b in zip(_flat(got[1]), _flat(want[1])):
        err = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                      1e-300)
        assert err <= F64_GRAD, (transform, err)


@pytest.mark.cuda
def test_k6_forward_over_reverse_raises(card):
    """A jvp of a grad (TRPO's use_fim False) needs the backward kernel's
    own derivative, which K6 does not have: it raises, it does not fall
    back to the loop."""
    net = _net(8, 16, True, torch.float64, card)
    x = torch.randn(6, 3, 8, dtype=torch.float64, device=card)
    params = {k: v.detach() for k, v in net.named_parameters()}
    tangents = {k: torch.ones_like(v) for k, v in params.items()}
    loss = lambda p: (functional_call(net, p, (x,)) ** 2).sum()
    with pytest.raises(RuntimeError, match="forward over reverse"):
        jvp(grad(loss), (params,), (tangents,))


class _Policy(torch.nn.Module):
    """A context bi-LSTM under a Gaussian head, as TRPO's policy input."""

    def __init__(self):
        super().__init__()
        self.rnn = RNN(8, 32, bi_dir=True)
        self.head = torch.nn.Linear(32, 3)
        self.log_std = torch.nn.Parameter(torch.full((3,), -0.5))

    def forward(self, x):
        mean = self.head(self.rnn(x))
        return mean, self.log_std.expand_as(mean)


@pytest.mark.cuda
def test_k6_fisher_product_matches_the_cpu(card):
    """rl/trpo.py's Fisher-vector product (one vjp and one jvp through the
    policy) through K6 on the card against the loop on the CPU, float64."""
    from egopose_tpu_torch.rl.trpo import fvp_fim
    torch.manual_seed(0)
    pol = _Policy().double()
    names = [n for n, _ in pol.named_parameters()]
    x = torch.randn(12, 5, 8, dtype=torch.float64)
    w = torch.rand(12, 5, dtype=torch.float64)
    n = sum(p.numel() for p in pol.parameters())
    v = torch.randn(n, dtype=torch.float64)

    def product(dev):
        pol.to(dev)
        params = tuple(p.detach() for p in pol.parameters())
        fn = lambda prm: functional_call(pol, dict(zip(names, prm)),
                                         (x.to(dev),))
        return fvp_fim(fn, params, w.to(dev), 1e-3)(v.to(dev))

    want = product("cpu")
    before = lstm.launches
    got = product(card)
    assert lstm.launches > before
    err = float((got.cpu() - want).abs().max()) / float(want.abs().max())
    assert err <= F64_GRAD, err


@pytest.mark.cuda
def test_k6_takes_extra_batch_dims(card):
    net = _net(4, 6, True, torch.float64, card)
    x = torch.randn(5, 2, 3, 4, dtype=torch.float64, device=card)
    y = net.recurrence(x, (net.rnn_f, net.rnn_b), (False, True))
    assert y.shape == (5, 2, 3, 6)
    assert float((y - _loop(net, x)).abs().max()) <= F64_OUT


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,hid,ndir,rows,shared", [
    (4, 64, 2, 1, True), (1024, 64, 2, 2, True), (4096, 64, 2, 8, True),
    (14800, 64, 1, 8, True), (1024, 128, 1, 8, False), (1, 128, 1, 8, False)])
def test_k6_rows_and_weight_placement(card, bsz, hid, ndir, rows, shared):
    """Float32 at the cells' launches on an H100 (132 SMs): W_hh in shared
    memory at H 64 with the most rows a thread that still give every SM a
    block, from L2 at H 128 with 8 rows; one decision for all three
    kernels."""
    if torch.cuda.get_device_properties(card).multi_processor_count != 132:
        pytest.skip("the expected rows are an H100's (132 SMs)")
    for kind in ("fwd", "bwd", "jvp"):
        occ = lstm.occupancy(bsz, hid, ndir, torch.float32, kind)
        assert (occ["rows_per_thread"], occ["w_in_shared"]) == \
            (rows, shared), (kind, occ)
        assert occ["blocks_per_sm"] >= 1
