"""Per-layer host time from the program's own spans
(``egopose_tpu_torch.utils.profile``): the tracer keeps the spans that
opened and closed while a torch.profiler session recorded, so in a
``--trace 1`` run those of the run's profiled slices, on the card's
clock of the slices' other numbers (the profiler's own cost included).

A layer's time a control step is the sum, over the span names of the
layer, of each name's mean self time a call; a span's self time is its
duration less its kept children's.  Every span below a step's root is
entered once a control step, so a name's mean a call is its time a step,
also where a slice cuts the first or the last step of its range.  A
program without the tracer (the parent of the commit that added it), or
one that kept no span of the layer, reads None."""
from __future__ import annotations

LAYERS = {"env": lambda n: n.startswith("env."),
          "nets": lambda n: n.startswith("nets."),
          "physics": lambda n: n.startswith("physics."),
          "failsafe": lambda n: n == "eval.failsafe"}


def program_spans():
    """The spans the program's tracer kept, or None where it has none."""
    try:
        from egopose_tpu_torch.utils import profile
    except ImportError:
        return None
    read = getattr(profile, "spans", None)
    return None if read is None else read()


def self_ns(spans) -> dict:
    """Each span's self time in ns, by id: its duration less the
    durations of its kept children."""
    out = {s.id: s.end - s.start for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end - s.start
    return out


def mean_self_ms(spans) -> dict:
    """Each span name's mean self time a call, in ms."""
    own, tot, n = self_ns(spans), {}, {}
    for s in spans:
        tot[s.name] = tot.get(s.name, 0) + own[s.id]
        n[s.name] = n.get(s.name, 0) + 1
    return {k: tot[k] / n[k] * 1e-6 for k in tot}


def layer_ms(spans, layer: str):
    """The layer's host ms a control step from ``spans``, or None."""
    if not spans:
        return None
    means = mean_self_ms(spans)
    names = [k for k in means if LAYERS[layer](k)]
    if not names:
        return None
    return sum(means[k] for k in names)


def read_layer(layer: str):
    return layer_ms(program_spans(), layer)
