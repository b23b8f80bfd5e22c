"""State-regression training and evaluation (counterpart of
egopose_tpu/cli/state_reg.py): modes train / test / save_inf, the same
checkpoint, result and log names.

    python -m egopose_tpu_torch.cli.state_reg --cfg subject_03 \\
        --mode train --synthetic [--max-epoch N] [--batch-chunks 4] \\
        [--transfer-dtype f16|f32] [--data-on-device] [--profile-dir DIR] \\
        [--device cuda|cpu]
    python -m egopose_tpu_torch.cli.state_reg --cfg subject_03 \\
        --mode test|save_inf --iter N [--test-feat ID]

A training step takes ``--batch-chunks`` dataset chunks (default
cfg.batch_size, or 4) side by side on the batch axis of the (T, B, ...)
input, each padded to fr_num + 30 frames by repeating its last frame,
with zero-masked slots filling the last batch; the loss is the masked
mean squared error, and the CNN's BatchNorm statistics run over every
frame of the batch, padding included, as in the JAX package.  The
2-channel flow is shipped to the device (in float16 with
``--transfer-dtype f16``), cast there and given its zero third channel
(``pad_flow_channels``).

Checkpoints: results/statereg/<cfg>/models/iter_%04d.p (training) and
iter_%04d_inf.p (save_inf, the net without its CNN), pickles of
({"state_net_dict": flax variables}, {"mean", "std"[, "cfg_id"]}) in the
JAX package's layout, so either package loads the other's; ``--iter``
also loads a reference-format (torch state_dict) checkpoint.  Test mode
writes results/statereg/<cfg>/results/iter_%04d_<data or test-feat>.p.

``--dp-devices N`` trains data-parallel over N ranks (the CLI starts them
itself, parallel/mesh.py): every rank assembles the same host batch and
keeps its share of the chunks (axis 1), the loss's denominator and the
CNN's BatchNorm statistics run over every rank's chunks
(models/batch_norm.py), a TCN temporal net's dropout masks are those of
the whole batch, and the gradients are summed before the optimizer step.
The lead rank logs and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import itertools
import logging
import os
import pickle
import queue
import threading
import time

import numpy as np
import torch

from ..parallel import mesh as meshlib
from ..utils.profile import count, span


def get_traj_from_state_pred(state_pred, init_pos, init_heading, dt,
                             traj_dim):
    """Integrate predicted kinematic states (de-headed qpos[2:] ++
    heading-frame qvel, per frame) into a qpos trajectory
    (state_reg.py:103-122), in float64 on the CPU."""
    from ..ops import math_utils as M
    from ..ops import quat as Q
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64))
    nq = (traj_dim + 1) // 2 + 1
    pos, heading = f64(init_pos), f64(init_heading)
    state_pred = f64(state_pred)
    traj = []
    for i in range(state_pred.shape[0]):
        qpos = torch.cat([pos, state_pred[i, :nq - 2]])
        qvel = state_pred[i, nq - 2:]
        qpos[3:7] = Q.quat_mul(heading, qpos[3:7])
        linv = Q.quat_rotate(heading, qvel[:3])
        angv = Q.quat_rotate(qpos[3:7], qvel[3:6])
        pos = pos + linv[:2] * dt
        heading = M.get_heading_q(Q.quat_mul(Q.quat_from_expmap(angv * dt),
                                             qpos[3:7]))
        traj.append(qpos)
    return torch.stack(traj).numpy()


def prepare_of(of_np, fr_num, dtype, pad_channels=True):
    """(T, H, W, 2) optical flow -> (fr_num, 1, H, W, 3 or 2) frames, the
    chunk padded to fr_num frames by repeating its last frame, and the
    (fr_num,) mask of its true frames.  fr_num is the largest chunk: the
    take's last chunk can reach cfg.fr_num + 30 frames.  With
    ``pad_channels=False`` the 2 flow channels stay as they are (the third,
    zero channel is added on the device: pad_flow_channels)."""
    t = of_np.shape[0]
    of = of_np
    if pad_channels:
        of = np.concatenate([of, np.zeros(of.shape[:-1] + (1,), of.dtype)],
                            axis=-1)
    if t < fr_num:
        of = np.concatenate([of, np.repeat(of[-1:], fr_num - t, axis=0)],
                            axis=0)
    mask = np.zeros(fr_num, dtype)
    mask[:t] = 1.0
    return of[:, None].astype(dtype), mask


def pad_flow_channels(of: torch.Tensor) -> torch.Tensor:
    """Append the zero third channel the CNN stems expect, on the tensor's
    device; a 3-channel input is returned as it is."""
    if of.shape[-1] == 2:
        of = torch.cat([of, of.new_zeros(of.shape[:-1] + (1,))], -1)
    return of


def load_state_net(cfg, path, no_cnn):
    """(state_dict, meta) of a statereg checkpoint at ``path`` in either
    package's layout or the reference's; ``no_cnn`` drops the CNN."""
    from ..models import torch_import as ti
    model_cp, meta = ti.tolerant_pickle_load(path)
    sd, _, _ = ti.maybe_import_statereg(
        model_cp, meta, cnn_type=cfg.cnn_type, v_net_type=cfg.v_net,
        causal=cfg.causal, no_cnn=no_cnn)
    return sd, meta


def save_state_net(path, net, meta):
    """Write ({"state_net_dict": flax variables}, meta), the JAX package's
    statereg checkpoint layout."""
    from ..convert import video_reg_net_to_jax
    with open(path, "wb") as f:
        pickle.dump(({"state_net_dict": video_reg_net_to_jax(
            net.state_dict())}, meta), f)


def make_net(cfg, state_dim, no_cnn, frame_shape, seed):
    """A VideoRegNet of the config with fresh weights from ``seed``."""
    from ..models.video_reg_net import VideoRegNet
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return VideoRegNet(state_dim, cfg.v_hdim, cfg.cnn_fdim, no_cnn=no_cnn,
                           frame_shape=frame_shape, mlp_dim=tuple(cfg.mlp_dim),
                           cnn_type=cfg.cnn_type, v_net_type=cfg.v_net,
                           v_net_param=cfg.v_net_param, causal=cfg.causal)


def train_step(net, opt, of, gt, mask, fr_margin, dtype, marks=None,
               mesh=None):
    """One step over a (T, B, ...) batch of B chunks: flow cast and padded
    to 3 channels on its device, the net in training mode (BatchNorm
    statistics over all T*B frames), the loss masked by ``mask`` (T', B).
    The gradient flows through the CNN's features in two backward passes
    (temporal net and head, then the CNN), the chain rule split where the
    step's two halves meet.  Each section is a span (``statereg.*``);
    ``marks(name)``, if given, is called after each.  ``mesh``: the batch
    is this rank's chunks; the loss is the global one and the gradients
    are summed over the ranks.  Returns the loss (a device tensor)."""
    mark = marks or (lambda name: None)
    with span("statereg.cnn_forward"):
        net.train()
        frames = pad_flow_channels(of.to(dtype))
        feats = net.features(frames)
    mark("cnn_forward")
    with span("statereg.temporal_forward"):
        feats_in = feats.detach().requires_grad_()
        pred = net.temporal(feats_in)[fr_margin:-fr_margin]
        err = ((gt - pred) ** 2 * mask[..., None]).sum(-1)
        n_valid = mask.sum() if mesh is None \
            else meshlib.all_reduce_sum(mesh, mask.sum(), "data")
        loss = err.sum() / torch.clamp(n_valid, min=1.0)
    mark("temporal_forward")
    with span("statereg.temporal_backward"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    mark("temporal_backward")
    with span("statereg.cnn_backward"):
        if net.cnn is not None:
            feats.backward(feats_in.grad)
    mark("cnn_backward")
    with span("statereg.optimizer"):
        if mesh is not None:
            params = [q for q in net.parameters() if q.grad is not None]
            for q, g in zip(params, meshlib.all_reduce_grads(
                    mesh, [q.grad for q in params], params)):
                q.grad = g
            loss = meshlib.all_reduce_sum(mesh, loss.detach(), "data")
        opt.step()
    mark("optimizer")
    return loss.detach()


def host_batches(dataset, n_chunks, fr_margin, state_dim, np_dtype,
                 transfer_dtype, pin=False):
    """The epoch's batches on the host: ``n_chunks`` dataset chunks (each
    padded to fr_num + 30 frames by repeating its last frame) stacked on
    the batch axis, the last batch filled with zero-masked copies of its
    first chunk.  Yields (flow (T, B, H, W, 2) in ``transfer_dtype``, gt
    (T', B, D), mask (T', B), frames) as tensors, pinned with ``pin``; each
    batch's assembly is a span (``statereg.assemble``).  The flow is
    written once, chunk by chunk, straight into the batch's tensor (by
    torch's threaded copy): the same values as prepare_of's padding
    stacked and cast, without their three intermediate copies."""
    chunk_max = dataset.fr_num + 30
    gt_len = chunk_max - 2 * fr_margin
    flow_dtype = torch.from_numpy(np.zeros(0, transfer_dtype)).dtype

    def chunk(item):
        of_np, traj_np, _ = item
        num = traj_np.shape[0] - 2 * fr_margin
        if num <= 0:
            return None
        gt = np.zeros((gt_len, state_dim), np_dtype)
        gt[:num] = traj_np[fr_margin:-fr_margin, :state_dim]
        mask = np.zeros(gt_len, np_dtype)
        mask[:num] = 1.0
        return np.asarray(of_np, np_dtype), gt, mask, num

    def stack(buf):
        of = torch.empty((chunk_max, len(buf)) + buf[0][0].shape[1:],
                         dtype=flow_dtype, pin_memory=pin)
        for j, b in enumerate(buf):
            x = torch.from_numpy(b[0])
            of[:len(x), j] = x
            of[len(x):, j] = x[-1]
        to = lambda x: torch.from_numpy(x).pin_memory() if pin \
            else torch.from_numpy(x)
        return (of, to(np.stack([b[1] for b in buf], 1)),
                to(np.stack([b[2] for b in buf], 1)), sum(b[3] for b in buf))

    chunks = (c for c in map(chunk, dataset) if c is not None)
    while True:
        with span("statereg.assemble"):
            buf = list(itertools.islice(chunks, n_chunks))
            if buf:
                pad = buf[0]
                buf += [(pad[0], pad[1], np.zeros_like(pad[2]), 0)] \
                    * (n_chunks - len(buf))
                batch = stack(buf)
        if not buf:
            return
        yield batch


def to_device(batch, device):
    """A host batch's tensors copied to ``device`` (asynchronously from
    pinned memory)."""
    of, gt, mask, num = batch
    put = lambda x: x.to(device, non_blocking=True)
    return put(of), put(gt), put(mask), num


def main(argv=None, epoch_hook=None, step_hook=None):
    """``epoch_hook(epoch, seconds, frames, loss, steps)``, if given, is
    called after each training epoch.  ``step_hook(when, step, net, opt,
    batch, loss)``, if given, is called before (``when`` "before", loss
    None) and after ("after", the step's loss, a device tensor) each
    training step, outside its spans: ``step`` counts the run's steps
    from 0 over every epoch, ``batch`` is the step's device batch (flow,
    gt, mask, trained frames).  An exception raised from a hook ends
    training there."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--mode", default="train")
    parser.add_argument("--data", default=None)
    parser.add_argument("--test-feat", default=None)
    parser.add_argument("--gpu-index", type=int, default=0)
    parser.add_argument("--iter", type=int, default=0)
    parser.add_argument("--synthetic", action="store_true", default=False)
    parser.add_argument("--max-epoch", type=int, default=None)
    parser.add_argument("--batch-chunks", type=int, default=None,
                        help="chunks per training batch; default "
                             "cfg.batch_size, or 4")
    parser.add_argument("--dp-devices", type=int, default=None)
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the second "
                             "training epoch there")
    parser.add_argument("--data-on-device", action="store_true",
                        default=False,
                        help="upload every batch of the epoch to the device "
                             "once and index them there (iter_method "
                             "'iter' without shuffle; streams otherwise)")
    parser.add_argument("--transfer-dtype", default="f32",
                        choices=("f16", "f32"),
                        help="dtype of the flow's host->device copy (cast "
                             "back on the device)")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (raises without "
                             "CUDA), cpu runs on the CPU")
    args = parser.parse_args(argv)
    if args.data is None:
        args.data = args.mode if args.mode in {"train", "test"} else "train"

    from .. import resolve_device
    from ..data.dataset import Dataset
    from ..utils.config import StateRegConfig
    from ..utils.log import ScalarWriter, create_logger

    device = resolve_device(args.device)
    dtype, np_dtype = torch.float32, np.float32
    cfg = StateRegConfig(args.cfg, create_dirs=(args.iter == 0))
    mesh = None
    if args.dp_devices is not None and args.mode == "train":
        n_chunks = batch_chunks(args, cfg)
        if n_chunks % args.dp_devices != 0:
            raise SystemExit(
                f"--batch-chunks {n_chunks} not divisible by "
                f"--dp-devices {args.dp_devices}")
        if not meshlib.in_ranks():
            return meshlib.run_cli(args.dp_devices, main, argv, epoch_hook,
                                   step_hook, device=device)
        mesh = meshlib.make_mesh(args.dp_devices, device=device)
        device = mesh.device
    lead = mesh is None or mesh.lead
    np.random.seed(cfg.seed)
    logger = create_logger(os.path.join(cfg.log_dir, "log.txt"),
                           file_handle=lead)
    if not lead:
        logger.setLevel(logging.WARNING)
    tb = ScalarWriter(cfg.tb_dir) if lead else None

    with span("setup.world"):
        dataset = Dataset(cfg.meta_id, args.data, cfg.fr_num,
                          cfg.iter_method, cfg.shuffle, 2 * cfg.fr_margin,
                          cfg.num_sample, synthetic=args.synthetic,
                          seed=cfg.seed)
    state_dim = (dataset.traj_dim - 1) // 2 + 6 if cfg.pose_only \
        else dataset.traj_dim
    no_cnn = args.mode == "save_inf" or args.test_feat is not None
    frame_shape = dataset.load_of(0, 0, 1).shape[1:3] + (3,) \
        if not no_cnn else (224, 224, 3)
    with span("setup.nets"):
        net = make_net(cfg, state_dim, no_cnn, frame_shape, cfg.seed).to(
            device=device, dtype=dtype)
        if args.iter > 0:
            cp_path = "%s/iter_%04d.p" % (cfg.model_dir, args.iter)
            logger.info("loading model from checkpoint: %s" % cp_path)
            sd, meta = load_state_net(cfg, cp_path, no_cnn)
            if args.data != "train":
                dataset.set_mean_std(meta["mean"], meta["std"])
            net.load_state_dict(sd)
    fr_margin = cfg.fr_margin
    chunk_max = cfg.fr_num + 30

    if args.mode == "train":
        return _train(args, cfg, net, dataset, state_dim, device, dtype,
                      np_dtype, logger, tb, epoch_hook, step_hook, mesh)
    if args.mode == "test":
        return _test(args, cfg, net, dataset, state_dim, fr_margin,
                     chunk_max, device, dtype, np_dtype, logger)
    if args.mode == "save_inf":
        cp_path = "%s/iter_%04d_inf.p" % (cfg.model_dir, args.iter)
        save_state_net(cp_path, net, {"mean": dataset.mean,
                                      "std": dataset.std, "cfg_id": cfg.id})
        logger.info("saved inference model to %s" % cp_path)
    return None


def batch_chunks(args, cfg) -> int:
    """Chunks per training batch: --batch-chunks, else cfg.batch_size
    when above 1, else 4."""
    return args.batch_chunks or (cfg.batch_size if cfg.batch_size > 1
                                 else 4)


def _train(args, cfg, net, dataset, state_dim, device, dtype, np_dtype,
           logger, tb, epoch_hook, step_hook=None, mesh=None):
    from ..models.batch_norm import BatchNorm
    from ..utils.profile import profiled
    fr_margin = cfg.fr_margin
    # optax.adam's defaults: the same update, eps outside the square root
    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    n_chunks = batch_chunks(args, cfg)
    logger.info("training with %d chunks per batch on %s" % (n_chunks,
                                                             device))
    tdtype = np.float16 if args.transfer_dtype == "f16" else np_dtype
    batches = lambda: host_batches(dataset, n_chunks, fr_margin, state_dim,
                                   np_dtype, tdtype, device.type == "cuda")
    lead = mesh is None or mesh.lead
    if mesh is not None:
        logger.info("data-parallel over %d ranks (chunk axis split)"
                    % mesh.size("data"))
        group = meshlib.Group(mesh, "data")
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.group = group
        if net.v_net_type == "tcn":
            net.v_net.lanes = (n_chunks, mesh.rank("data") * n_chunks
                               // mesh.size("data"))
        whole = batches
        shard = lambda x: meshlib.lane_slice(mesh, x, "data", dim=1)
        batches = lambda: ((shard(of), shard(gt), shard(mask), num)
                           for of, gt, mask, num in whole())

    def device_batches():
        """The host batches assembled on a prefetch thread (two ahead), so
        host work overlaps the device's; copied here."""
        q = queue.Queue(maxsize=2)
        failure = []

        def worker():
            try:
                for batch in batches():
                    q.put(batch)
            except BaseException as e:      # re-raised on the main thread
                failure.append(e)
            finally:
                q.put(None)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                if failure:
                    raise failure[0]
                return
            yield to_device(item, device)

    resident = None
    if args.data_on_device:
        if cfg.shuffle or cfg.iter_method != "iter":
            logger.info("--data-on-device needs iter_method 'iter' without "
                        "shuffle (a fixed batch order); streaming instead")
        else:
            t_up = time.time()
            resident = [to_device(b, device) for b in batches()]
            if device.type == "cuda":
                # every copy above was queued on the current stream: this
                # waits for all of them
                torch.cuda.synchronize(device)
            up_bytes = sum(x.numel() * x.element_size()
                           for b in resident for x in b[:3])
            logger.info("data-on-device: %d batches (%.0f MB) resident in "
                        "%.1fs" % (len(resident), up_bytes / 1e6,
                                   time.time() - t_up))

    max_epoch = args.max_epoch or cfg.num_epoch
    hook = step_hook or (lambda *a: None)
    step = 0
    for i_epoch in range(args.iter, max_epoch):
        # the second epoch: the first is the warm-up (cuDNN's first calls,
        # the allocator's growth), not the steady state
        profiling = args.profile_dir and i_epoch == args.iter + 1 and lead
        t0 = time.time()
        n_sample, losses, counts = 0, [], []
        with profiled(profiling and args.profile_dir, device, logger):
            source = iter(resident if resident is not None
                          else device_batches())
            while True:
                with span("statereg.fetch", step):
                    batch = next(source, None)
                if batch is None:
                    break
                of, gt, mask, num = batch
                hook("before", step, net, opt, batch, None)
                with span("statereg.step", step):
                    count("statereg.padded_frames",
                          of.shape[0] * of.shape[1])
                    loss = train_step(net, opt, of, gt, mask, fr_margin,
                                      dtype, mesh=mesh)
                hook("after", step, net, opt, batch, loss)
                losses.append(loss)      # read at the epoch's end
                counts.append(num)
                n_sample += num
                step += 1
            ep_loss = float(sum(float(l) * c for l, c in zip(losses, counts))
                            / max(n_sample, 1))
        dt_ep = time.time() - t0
        logger.info("epoch {:4d}    time {:.2f}     nsample {}   "
                    "loss {:.4f}   frames/s {:.1f}"
                    .format(i_epoch, dt_ep, n_sample, ep_loss,
                            n_sample / max(dt_ep, 1e-9)))
        if epoch_hook is not None:
            epoch_hook(i_epoch, dt_ep, n_sample, ep_loss, len(losses))
        if tb:
            tb.scalar("loss", ep_loss, i_epoch)
            tb.scalar("frames_per_sec", n_sample / max(dt_ep, 1e-9), i_epoch)
        if cfg.save_model_interval > 0 and \
                (i_epoch + 1) % cfg.save_model_interval == 0:
            meshlib.lead_writes(
                mesh, save_state_net,
                "%s/iter_%04d.p" % (cfg.model_dir, i_epoch + 1), net,
                {"mean": dataset.mean, "std": dataset.std})
    return net, dataset


@torch.no_grad()
def _test(args, cfg, net, dataset, state_dim, fr_margin, chunk_max, device,
          dtype, np_dtype, logger):
    from ..ops import math_utils as M
    net.eval()
    dataset.iter_method = "iter"
    dataset.shuffle = False
    n_sample, ep_loss = 0, 0.0
    res_pred, res_orig, meta = {}, {}, {}
    if args.test_feat is None:
        state_pred_arr, traj_orig_arr = [], []
        take = dataset.takes[0]
        it = iter(dataset)
        while True:
            try:
                of_np, traj_np, traj_orig_np = next(it)
            except StopIteration:
                break
            num = traj_np.shape[0] - 2 * fr_margin
            if num <= 0:
                continue
            of, _ = prepare_of(of_np, chunk_max, np_dtype,
                               pad_channels=False)
            pred = net(pad_flow_channels(torch.from_numpy(of).to(device)))
            pred = pred[fr_margin:fr_margin + num, 0].double().cpu().numpy()
            gt = traj_np[fr_margin:-fr_margin, :state_dim]
            ep_loss += float(((gt - pred) ** 2).sum(-1).mean()) * num
            n_sample += num
            state_pred_arr.append(pred * dataset.std[None, :state_dim]
                                  + dataset.mean[None, :state_dim])
            traj_orig_arr.append(traj_orig_np[fr_margin:-fr_margin])
            if dataset.cur_ind >= len(dataset.takes) or \
                    dataset.takes[dataset.cur_tid] != take:
                # the take's chunks are in: integrate its trajectory
                sp = np.vstack(state_pred_arr)
                to = np.vstack(traj_orig_arr)
                init_heading = M.get_heading_q(
                    torch.as_tensor(to[0, 3:7], dtype=torch.float64)).numpy()
                res_pred[take] = get_traj_from_state_pred(
                    sp, to[0, :2], init_heading, dataset.dt, dataset.traj_dim)
                res_orig[take] = to
                state_pred_arr, traj_orig_arr = [], []
                if dataset.cur_ind < len(dataset.takes):
                    take = dataset.takes[dataset.cur_tid]
        ep_loss /= max(n_sample, 1)
        results = {"traj_pred": res_pred, "traj_orig": res_orig}
        res_path = "%s/iter_%04d_%s.p" % (cfg.result_dir, args.iter,
                                          args.data)
    else:
        feat_file = "%s/features/cnn_feat_%s.p" % (dataset.base_folder,
                                                    args.test_feat)
        with open(feat_file, "rb") as f:
            cnn_feat_dict, _ = pickle.load(f)
        for take, cnn_feat in cnn_feat_dict.items():
            x = torch.as_tensor(np.asarray(cnn_feat)).to(device=device,
                                                         dtype=dtype)
            pred = net(x[:, None])[fr_margin:-fr_margin, 0]
            pred = pred.double().cpu().numpy() \
                * dataset.std[None, :state_dim] \
                + dataset.mean[None, :state_dim]
            res_pred[take] = get_traj_from_state_pred(
                pred, np.zeros(2), np.array([1.0, 0, 0, 0]), dataset.dt,
                dataset.traj_dim)
            n_sample += pred.shape[0]
        results = {"traj_pred": res_pred}
        res_path = "%s/iter_%04d_%s.p" % (cfg.result_dir, args.iter,
                                          args.test_feat)
    meta.update({"algo": "state_reg", "num_sample": n_sample,
                 "epoch_loss": ep_loss})
    os.makedirs(cfg.result_dir, exist_ok=True)
    with open(res_path, "wb") as f:
        pickle.dump((results, meta), f)
    logger.info("nsample {}   loss {:.4f}".format(n_sample, ep_loss))
    logger.info("saved results to %s" % res_path)
    return results


if __name__ == "__main__":
    main()
