"""Faults planted in the timed path of entry `refine`: the program's
refine broken, the input views handed back unrefined, or one compared view
(the front anchor) mirrored where it is produced."""

KINDS = ("unchanged", "altered")


def break_timed(monkeypatch, kind):
    from gaussianip_tpu_torch.system import refine

    real = refine.refine_views

    def broken(models, images, *a, **k):
        out = real(models, images, *a, **k)
        if kind == "unchanged":
            return images
        out = out.clone()
        i = refine.view_index("front")
        out[i] = out[i].flip(1)
        return out

    monkeypatch.setattr(refine, "refine_views", broken)
