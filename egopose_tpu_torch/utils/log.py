"""Text and scalar logging for the CLIs (counterpart of
egopose_tpu/utils/log.py: create_logger and ScalarWriter.scalar).  Scalars
go to a TensorBoard event file when tensorboard's writer imports, else to
scalars.jsonl."""
from __future__ import annotations

import json
import logging
import os
import time


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


class ScalarWriter:
    """Scalar summaries: a tensorboard event file if tensorboard imports,
    else JSONL lines {tag, value, step, ts}."""

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
            s = self._Summary(value=[self._Summary.Value(
                tag=tag, simple_value=float(value))])
            self._tb.add_event(self._Event(summary=s, step=step,
                                           wall_time=time.time()))
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": step,
                                          "ts": time.time()}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
