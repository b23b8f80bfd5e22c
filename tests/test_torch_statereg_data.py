"""The state-regression data of egopose_tpu_torch against the JAX package:
the synthetic world (default 32x32 RandomState draws and the overridden
resolution's SFC64 draws), trajectory channels, mean/std, ``iter`` chunks
with overlap and ``sample`` draws, all exactly equal for the same seed;
a file-backed split (packed and per-frame flow, mean/std carried to the
test split) with its derived channels within 1e-12; the native
packed-flow loader against numpy, and its build and read failures
raising instead of falling back; StateRegConfig key by key on every
shipped statereg config."""
import os

import numpy as np
import pytest
import torch
import yaml

from egopose_tpu.data.dataset import Dataset as JDataset
from egopose_tpu.utils.config import StateRegConfig as JStateRegConfig
from egopose_tpu_torch.data import fastload
from egopose_tpu_torch.data.dataset import Dataset, pack_optical_flow
from egopose_tpu_torch.utils.config import StateRegConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on few cores; the small CPU tensors
    here gain nothing from intra-op threads, which oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunks(ds):
    return [tuple(x.copy() if x is not None else None for x in c)
            for c in ds]


def _assert_same(a, b, derived_tol=0.0):
    """Flow and original trajectories equal; the derived channels (the
    de-headed root and the finite-difference velocities, their mean, std
    and normalised values) equal too, or within ``derived_tol`` where the
    roots rotate (float64 quaternion math rounds differently in the two
    libraries)."""
    same = np.testing.assert_array_equal if derived_tol == 0 else \
        lambda x, y: np.testing.assert_allclose(x, y, rtol=derived_tol,
                                                atol=derived_tol)
    assert a.takes == b.takes and a.traj_dim == b.traj_dim \
        and a.len == b.len
    for x, y in zip(a.trajs, b.trajs):
        same(x, y)
    for x, y in zip(a.orig_trajs, b.orig_trajs):
        np.testing.assert_array_equal(x, y)
    same(a.mean, b.mean)
    same(a.std, b.std)
    ca, cb = _chunks(a), _chunks(b)
    assert len(ca) == len(cb) > 0
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[2], y[2])
        same(x[1], y[1])
    return ca


@pytest.mark.parametrize("method", ["iter", "sample"])
def test_synthetic_dataset_equals_jax(method, monkeypatch):
    monkeypatch.setenv("EGOPOSE_SYN_LEN", "90")
    kw = dict(iter_method=method, overlap=6, num_sample=100, shuffle=True,
              synthetic=True, seed=3)
    chunks = _assert_same(Dataset("x", "train", 24, **kw),
                          JDataset("x", "train", 24, **kw))
    of, norm, orig = chunks[0]
    assert of.shape == (24, 32, 32, 2) and of.dtype == np.float32
    assert norm.shape == (24, 57 + 58) and orig.shape == (24, 59)
    # the hand pose is zeroed (statereg_dataset.py:45-46)
    assert not orig[:, 32:35].any() and not orig[:, 42:45].any()
    if method == "iter":
        # 6 frames of overlap between consecutive chunks of a take
        np.testing.assert_array_equal(chunks[0][0][-6:], chunks[1][0][:6])


def test_overridden_resolution_draws_equal_jax(monkeypatch):
    """EGOPOSE_SYN_RES (the production 224 path's SFC64 draws), here at 40
    pixels, with EGOPOSE_SYN_TAKES and EGOPOSE_SYN_LEN."""
    for key, val in (("EGOPOSE_SYN_RES", "40"), ("EGOPOSE_SYN_TAKES", "3"),
                     ("EGOPOSE_SYN_LEN", "50")):
        monkeypatch.setenv(key, val)
    ds = Dataset("x", "train", 10, overlap=2, synthetic=True, seed=1)
    chunks = _assert_same(ds, JDataset("x", "train", 10, overlap=2,
                                       synthetic=True, seed=1))
    assert len(ds.takes) == 3 and chunks[0][0].shape == (10, 40, 40, 2)


@pytest.fixture(scope="module")
def file_world(tmp_path_factory):
    """A file-backed world: trajectories, a meta with a train/test split
    and a capture offset, take a's flow packed, take b's per frame."""
    root = tmp_path_factory.mktemp("world")
    rng = np.random.RandomState(0)
    takes = {"a": 70, "b": 64}
    for d in ("traj", "meta", "fpv_of/b"):
        os.makedirs(root / d)
    for take, n in takes.items():
        traj = np.zeros((n, 59))
        traj[:, 2] = 0.9 + 0.01 * rng.randn(n)
        traj[:, 3] = 1.0
        traj[:, 4:7] = 0.1 * rng.randn(n, 3)
        traj[:, 3:7] /= np.linalg.norm(traj[:, 3:7], axis=1, keepdims=True)
        traj[:, :2] = np.cumsum(0.01 * rng.randn(n, 2), 0)
        traj[:, 7:] = 0.3 * rng.randn(n, 52)
        traj.dump(str(root / "traj" / f"{take}_traj.p"))
        flow = rng.randn(n + 3, 8, 8, 2).astype(np.float32)
        if take == "a":
            np.save(root / "fpv_of" / "a.npy", flow)
        else:
            for i, frame in enumerate(flow):
                np.save(root / "fpv_of" / "b" / f"{i:05d}.npy", frame)
    meta = {"train": ["a"], "test": ["b"], "capture": {"fps": 30},
            "video_mocap_sync": {"a": [3, 0, 70], "b": [2, 1, 60]}}
    with open(root / "meta" / "m.yml", "w") as f:
        yaml.safe_dump(meta, f)
    return str(root)


def test_file_dataset_equals_jax(file_world):
    kw = dict(overlap=4, base_folder=file_world)
    train = Dataset("m", "train", 20, **kw)
    _assert_same(train, JDataset("m", "train", 20, **kw), 1e-12)
    assert train._packed_reader is not None      # a's packed flow
    test, jtest = Dataset("m", "test", 20, **kw), \
        JDataset("m", "test", 20, **kw)
    assert test.mean is None                     # carried from training
    test.set_mean_std(train.mean, train.std)
    jtest.set_mean_std(train.mean, train.std)
    _assert_same(test, jtest, 1e-12)


def test_pack_optical_flow_then_read(file_world, tmp_path):
    import shutil
    shutil.copytree(os.path.join(file_world, "fpv_of", "b"),
                    tmp_path / "fpv_of" / "b")
    shape = pack_optical_flow(str(tmp_path), "b")
    assert shape == (67, 8, 8, 2)
    reader = fastload.PackedFlowReader(
        {"b": str(tmp_path / "fpv_of" / "b.npy")}, n_threads=2)
    got = reader.read_batch([("b", 5, 7)])[0]
    want = np.stack([np.load(tmp_path / "fpv_of" / "b" / f"{i:05d}.npy")
                     for i in range(5, 12)])
    np.testing.assert_array_equal(got, want)


def test_packed_read_matches_numpy(tmp_path):
    rng = np.random.RandomState(1)
    data, paths = {}, {}
    for take in ("a", "b"):
        data[take] = rng.randn(40, 6, 6, 2).astype(np.float32)
        paths[take] = str(tmp_path / f"{take}.npy")
        np.save(paths[take], data[take])
    assert os.path.dirname(fastload.library_path()) == fastload.BUILD_DIR
    reader = fastload.PackedFlowReader(paths, n_threads=4)
    reqs = [("a", 0, 5), ("b", 10, 7), ("a", 35, 5), ("b", 0, 40)]
    for (take, s, c), out in zip(reqs, reader.read_batch(reqs)):
        np.testing.assert_array_equal(out, data[take][s:s + c])
    with pytest.raises(IndexError):
        reader.read_batch([("a", 38, 5)])


def test_failed_build_raises(tmp_path, monkeypatch):
    """No quiet fallback to numpy reads: a source cc cannot compile makes
    the loader raise."""
    bad = tmp_path / "fastload.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(fastload, "_SRC", str(bad))
    monkeypatch.setattr(fastload, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(fastload, "_lib", None)
    with pytest.raises(RuntimeError, match="cc failed"):
        fastload.get_lib()
    np.save(tmp_path / "a.npy", np.zeros((3, 2, 2, 2), np.float32))
    with pytest.raises(RuntimeError, match="cc failed"):
        fastload.PackedFlowReader({"a": str(tmp_path / "a.npy")})


@pytest.mark.parametrize("cfg_id", sorted(
    f[:-4] for f in os.listdir(os.path.join(REPO, "config", "statereg"))))
def test_state_reg_config_matches_jax(cfg_id):
    root = os.path.join(REPO, "config")
    jc = JStateRegConfig(cfg_id, config_root=root)
    tc = StateRegConfig(cfg_id, config_root=root)
    assert vars(tc).keys() == vars(jc).keys()
    for key, val in vars(jc).items():
        assert getattr(tc, key) == val, key


@pytest.mark.parametrize("transfer", [np.float32, np.float16])
def test_host_batches_equal_padded_stack(transfer, monkeypatch):
    """host_batches writes each chunk's flow straight into the batch: the
    same flow as prepare_of's padding stacked on the batch axis and cast,
    the last batch filled with zero-masked copies of its first chunk."""
    from egopose_tpu_torch.cli.state_reg import host_batches, prepare_of
    monkeypatch.setenv("EGOPOSE_SYN_LEN", "75")
    ds = Dataset("x", "train", 24, overlap=6, synthetic=True, seed=3)
    chunks = _chunks(ds)
    got = list(host_batches(ds, 4, 3, 20, np.float32, transfer))
    assert len(got) == -(-len(chunks) // 4) and len(chunks) % 4 != 0
    for k, (of, gt, mask, num) in enumerate(got):
        part = chunks[4 * k:4 * k + 4]
        full = part + [part[0]] * (4 - len(part))
        want = np.stack([prepare_of(c[0], 54, np.float32,
                                    pad_channels=False)[0][:, 0]
                         for c in full], 1).astype(transfer)
        assert of.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(of.numpy(), want)
        assert gt.shape == (48, 4, 20) and mask.shape == (48, 4)
        np.testing.assert_array_equal(mask.numpy().sum(0),
                                      [len(c[0]) - 6 for c in part]
                                      + [0] * (4 - len(part)))
        assert num == sum(len(c[0]) - 6 for c in part)
