"""Communication audit of multi-rank programs (counterpart of
egopose_tpu/parallel/audit.py).

The JAX package parses the compiled HLO of a jitted, mesh-sharded function
for its collectives.  The port compiles no HLO: every collective of the
port runs through parallel/mesh.py, which notes each one here while an
``audit.record()`` block is open.  So there is no HLO parser; the
inventory is what ran, one ``Collective`` per call, with the JAX fields:
kind, dtype, result shape, bytes and an estimate of the link traffic per
rank (ring algorithms: an all-reduce moves 2(n-1)/n of the buffer per
rank, an all-gather (n-1)/n of its result, a broadcast its buffer).
``summarize`` and ``assert_dp_pattern`` are the JAX functions: the
data-parallel contract is that gradients ride all-reduces and the
lane-sharded batch is never gathered.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

_RECORDING: list | None = None


class Collective(NamedTuple):
    kind: str
    dtype: str
    shape: tuple
    bytes: int          # result buffer size
    ici_bytes: float    # estimated per-rank link traffic (ring)


@contextlib.contextmanager
def record():
    """Inventory every collective that parallel/mesh.py runs inside the
    block: yields the list the Collectives are appended to."""
    global _RECORDING
    outer, _RECORDING = _RECORDING, []
    try:
        yield _RECORDING
    finally:
        if outer is not None:
            outer.extend(_RECORDING)
        _RECORDING = outer


def note(kind: str, result: torch.Tensor, n_ranks: int):
    """Called by parallel/mesh.py for each collective: ``result`` is the
    buffer the collective produces on this rank."""
    if _RECORDING is None:
        return
    nbytes = result.numel() * result.element_size()
    if kind == "all-reduce":
        ici = 2.0 * (n_ranks - 1) / n_ranks * nbytes
    elif kind == "all-gather":
        ici = (n_ranks - 1) / n_ranks * nbytes
    else:  # broadcast
        ici = float(nbytes)
    _RECORDING.append(Collective(kind, _DTYPE_NAMES[result.dtype],
                                 tuple(result.shape), nbytes, ici))


def collectives_of(recorded):
    """The inventory of a ``record()`` block (the JAX function parses it
    out of compiled HLO text; here it was recorded as it ran)."""
    return list(recorded)


def summarize(found, label=""):
    """Human-readable one-block summary; returns total link bytes."""
    by_kind = {}
    for c in found:
        by_kind.setdefault(c.kind, []).append(c)
    total = sum(c.ici_bytes for c in found)
    lines = [f"collective audit{' [' + label + ']' if label else ''}: "
             f"{len(found)} ops, ~{total / 1024:.1f} KiB ICI per step"]
    for kind in sorted(by_kind):
        cs = by_kind[kind]
        b = sum(c.bytes for c in cs)
        big = max(cs, key=lambda c: c.bytes)
        lines.append(f"  {kind:20s} x{len(cs):<4d} {b / 1024:9.1f} KiB "
                     f"(largest {big.dtype}{list(big.shape)})")
    return "\n".join(lines), total


def assert_dp_pattern(found, batch_bytes_per_device: int, label=""):
    """Assert the data-parallel contract: gradients ride all-reduce; the
    lane-sharded batch is never gathered.  ``batch_bytes_per_device`` is the
    size of one rank's shard of the largest lane-sharded array; any
    all-gather or all-to-all moving at least that much is a sharding leak."""
    leaks = [c for c in found
             if c.kind in ("all-gather", "all-to-all")
             and c.bytes >= batch_bytes_per_device]
    if leaks:
        desc = ", ".join(f"{c.kind} {c.dtype}{list(c.shape)}" for c in leaks)
        raise AssertionError(
            f"batch-sized gather collectives in {label or 'program'}: "
            f"{desc} -- a lane-sharded array is being re-gathered; check "
            f"the shardings (parallel/mesh.py)")
