"""Tiny sizes of the cells, for the CPU tests: the same configuration
keys at test widths, and the limits that hold at these sizes. Those were
set as the cells' own (benchmark/control.py, here on the CPU: the program
on 8 seeds, 6 for the refine, the control and the planted fault on 3):

  stage 1  grad: program up to 6.3e-3, float8 control from 1.43e-2 (under
           three times), half the batch from 0.25 -> 5e-2; change:
           program up to 6.7e-3, control 8.0e-3 to 1.7e-2, half the batch
           from 2.5e-2, the state unchanged 1 -> 3e-2; grad_diff: program
           0.032 to 0.040, control from 0.34, half the batch 0.97 -> 0.12
           (loss: program up to 6.8e-4, control from 8.1e-4; not compared,
           as on the card).
  stage 2  rms: program up to 1.10e-2, control from 9.8e-2 -> 3e-2.
  stage 3  the cell's own limits: both sides are the same float32 code on
           the CPU and read 0; TF32 does not exist there."""

TINY_SD15 = {
    "unet": {"block_out_channels": [32, 64], "layers_per_block": 1,
             "cross_attention_dim": 32, "attention_head_dim": 4,
             "norm_groups": 8},
    "controlnet": {"conditioning_embed_channels": [8, 16]},
    "vae": {"block_out_channels": [16, 32], "layers_per_block": 1,
            "norm_groups": 8},
    "conditioning": {"text_tokens": 8, "context_dim": 32},
    "guidance": {"image_size": 32},
    "avatar": {"points": 1500, "capacity": 2048},
    "lpips": {"stages": [[8, 1], [16, 1]]},
    "targets": [32, 20, 15, 3],
}
TINY_PARAMS = {
    "stage1-guided-512": {"views": 2, "resolution": 32, "cfg_batch": 6,
                          "trace_units": 1},
    "stage3-recon-1024": {"resolution": 64, "trace_units": 1},
    "stage2-vcr-1024": {"resolution": 32, "num_steps": 2},
}


TINY_LIMITS = {
    "stage1-guided-512": {"grad": 5e-2, "change": 3e-2, "grad_diff": 0.12},
    "stage2-vcr-1024": {"rms": 3e-2},
}


def shrink(cfg: dict, wl: dict) -> None:
    for k, v in TINY_SD15.items():
        if isinstance(cfg.get(k), dict):
            cfg[k].update(v)
        elif k in cfg:
            cfg[k] = v
    if "stage3" in cfg:  # the crop of a 64^2 render
        cfg["stage3"].update(crop_y=[4, 44], crop_x=[10, 40])
    wl["params"].update(TINY_PARAMS.get(wl["name"], {}))
    if "limits" in wl:
        wl["limits"].update(TINY_LIMITS.get(wl["name"], {}))
