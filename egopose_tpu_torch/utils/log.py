"""Text and summary logging for the CLIs (counterpart of
egopose_tpu/utils/log.py).  Scalars, images and histograms go to a
TensorBoard event file when tensorboard's writer imports, else to
scalars.jsonl (an image as its shape, a histogram as its counts and
edges).  Images are encoded as PNG here, with zlib: no imaging library is
needed."""
from __future__ import annotations

import json
import logging
import os
import struct
import time
import zlib

import numpy as np


def create_logger(filename=None, file_handle=True):
    logger = logging.getLogger("egopose_tpu_torch")
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)
    logger.setLevel(logging.DEBUG)
    fmt = logging.Formatter("%(asctime)s %(message)s", "%m-%d %H:%M:%S")
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filename and file_handle:
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def to_uint8_image(img, scale=None):
    """An image array as uint8: uint8 passes through; a float image is
    mapped by ``scale``, a fixed convention never inferred from the data:
    "unit" ([0, 1] x 255, the default) or "byte" ([0, 255]), clipped to the
    range first and NaN read as 0."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    img = np.nan_to_num(np.asarray(img, np.float64))
    if scale is None:
        scale = "unit"
    if scale == "byte":
        img = np.clip(img, 0.0, 255.0)
    elif scale == "unit":
        img = np.clip(img, 0.0, 1.0) * 255.0
    else:
        raise ValueError(f"unknown image scale {scale!r} (unit|byte|None)")
    return img.astype(np.uint8)


def png_bytes(img: np.ndarray) -> bytes:
    """An (H, W, C) uint8 image (C 1, 3 or 4) as an 8-bit PNG file."""
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]

    def chunk(kind, data):
        body = kind + data
        return struct.pack(">I", len(data)) + body \
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], 1)
    return b"\x89PNG\r\n\x1a\n" \
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)) \
        + chunk(b"IDAT", zlib.compress(rows.tobytes())) \
        + chunk(b"IEND", b"")


class ScalarWriter:
    """Summaries: a tensorboard event file if tensorboard imports, else
    JSONL lines {tag, value | image_shape | histogram, step, ts}."""

    def __init__(self, logdir):
        os.makedirs(logdir, exist_ok=True)
        self._tb = self._jsonl = None
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import \
                EventFileWriter
        except ImportError:
            self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        else:
            self._tb = EventFileWriter(logdir)
            self._Summary, self._Event = Summary, Event

    def scalar(self, tag, value, step):
        if self._tb is not None:
            self._add_summary(self._Summary.Value(
                tag=tag, simple_value=float(value)), step)
        else:
            self._write_jsonl(tag=tag, value=float(value), step=step)

    def _add_summary(self, value, step):
        self._tb.add_event(self._Event(summary=self._Summary(value=[value]),
                                       step=step, wall_time=time.time()))

    def _write_jsonl(self, **record):
        self._jsonl.write(json.dumps(dict(record, ts=time.time())) + "\n")
        self._jsonl.flush()

    def image(self, tag, img, step, scale=None):
        """Image summary: ``img`` (H, W, C) uint8, or float with ``scale``
        naming its range (to_uint8_image: "unit" unless given)."""
        img = to_uint8_image(img, scale)
        if self._tb is not None:
            if img.ndim == 2:
                img = img[..., None]
            im = self._Summary.Image(height=img.shape[0], width=img.shape[1],
                                     colorspace=img.shape[-1],
                                     encoded_image_string=png_bytes(img))
            self._add_summary(self._Summary.Value(tag=tag, image=im), step)
        else:
            self._write_jsonl(tag=tag, image_shape=list(img.shape),
                              step=step)

    def histogram(self, tag, values, step, bins=64):
        """Histogram summary of the finite values; empty or all-non-finite
        input writes nothing (a logging call never stops training)."""
        values = np.asarray(values, np.float64).ravel()
        values = values[np.isfinite(values)]
        if values.size == 0:
            return
        counts, edges = np.histogram(values, bins=bins)
        if self._tb is not None:
            from tensorboard.compat.proto.summary_pb2 import HistogramProto
            h = HistogramProto(
                min=float(values.min()), max=float(values.max()),
                num=int(values.size), sum=float(values.sum()),
                sum_squares=float((values ** 2).sum()),
                bucket_limit=edges[1:].tolist(), bucket=counts.tolist())
            self._add_summary(self._Summary.Value(tag=tag, histo=h), step)
        else:
            self._write_jsonl(tag=tag, histogram={
                "counts": counts.tolist(), "edges": edges.tolist()},
                step=step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
