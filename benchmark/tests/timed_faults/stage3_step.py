"""Faults planted in the timed path of entry `stage3_step`: the
program's stage-3 step broken in the same two ways as stage 1's, its state
handed back unchanged, or half of the views left out."""

from benchmark import stack

KINDS = ("unchanged", "half_batch")


def break_timed(monkeypatch, kind):
    from benchmark.entries import stage3_step

    real = stage3_step._setup

    def setup(root, *a, **k):
        out = list(real(root, *a, **k))
        if root == stack.PROGRAM:
            fn = out[2]
            out[2] = ((lambda ts, v: (ts, fn(ts, v)[1])) if kind ==
                      "unchanged" else
                      (lambda ts, v: fn(ts, v[:v.shape[0] // 2])))
        return tuple(out)

    monkeypatch.setattr(stage3_step, "_setup", setup)
