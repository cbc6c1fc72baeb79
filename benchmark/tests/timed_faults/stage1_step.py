"""Faults planted in the timed path of entry `stage1_step`: the
program's stage-1 step broken, its state handed back unchanged, or half of
the views left out and the loss a mean over the rest. The reference's
steps stay sound."""

from benchmark import stack

KINDS = ("unchanged", "half_batch")


def break_timed(monkeypatch, kind):
    from benchmark.entries import stage1_step

    real = stage1_step._make_step

    def make(pkg, cfg, p, guid, fault=None):
        if not pkg.stage1.__name__.startswith(stack.PROGRAM + "."):
            return real(pkg, cfg, p, guid, fault)
        if kind == "half_batch":
            return real(pkg, cfg, p, guid, "half_batch")
        step = real(pkg, cfg, p, guid)
        return lambda ts, gen: (ts, step(ts, gen)[1])

    monkeypatch.setattr(stage1_step, "_make_step", make)
