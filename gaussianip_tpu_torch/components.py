"""Config-compatible component registry entries (port of
gaussianip_tpu/components.py).

Importing this module registers the config type names of configs/exp.yaml
(`data_type: random-camera-datamodule`, `guidance_type: ipa-guidance`,
`prompt_processor_type: ipa-prompt-processor`, `system_type:
gaussianip-system`) so that they resolve through
gaussianip_tpu_torch.find()."""

from __future__ import annotations

import gaussianip_tpu_torch as gt


@gt.register("random-camera-datamodule")
class RandomCameraDataModule:
    """Factory facade: the camera sampler config and the eval orbits from a
    `data:` config dict. Draws come from a torch.Generator."""

    def __init__(self, data_cfg: dict, height=None, width=None,
                 batch_size=None):
        from .data.sampler import CameraSamplerConfig

        d = data_cfg
        self.cfg = CameraSamplerConfig(
            height=int(height or d.get("height", 1024)),
            width=int(width or d.get("width", 1024)),
            batch_size=int(batch_size or d.get("batch_size", 4)),
            elevation_range=tuple(d.get("elevation_range", (-30, 30))),
            azimuth_range=tuple(d.get("azimuth_range", (-180, 180))),
            camera_distance_range=tuple(d.get("camera_distance_range",
                                              (1.3, 1.7))),
            fovy_range=tuple(d.get("fovy_range", (40, 70))),
            enable_near_head_poses=bool(d.get("enable_near_head_poses", True)),
            enable_near_back_poses=bool(d.get("enable_near_back_poses", True)),
            head_camera_distance_range=tuple(
                d.get("head_camera_distance_range", (0.4, 0.6))),
            back_camera_distance_range=tuple(
                d.get("back_camera_distance_range", (0.6, 0.8))),
            head_prob=float(d.get("head_prob", 0.25)),
            back_prob=float(d.get("back_prob", 0.2)),
            head_start_step=int(d.get("head_start_step", 1200)),
            back_start_step=int(d.get("back_start_step", 1200)),
            head_azimuth_range=tuple(d.get("head_azimuth_range", (0, 180))),
            back_azimuth_range=tuple(d.get("back_azimuth_range", (-180, 0))),
            eval_height=int(d.get("eval_height", 1024)),
            eval_width=int(d.get("eval_width", 1024)),
            eval_elevation_deg=float(d.get("eval_elevation_deg", 5.0)),
            eval_camera_distance=float(d.get("eval_camera_distance", 1.8)),
            eval_camera_distance_head=float(
                d.get("eval_camera_distance_head", 0.6)),
            eval_fovy_deg=float(d.get("eval_fovy_deg", 70.0)),
            n_test_views=int(d.get("n_test_views", 144)),
        )

    def sample_train(self, generator, step, device="cuda"):
        from .data.sampler import sample_train_batch

        return sample_train_batch(self.cfg, generator, step, device)

    def eval_orbit(self, split="val", device="cuda"):
        from .data.sampler import eval_orbit_batch

        return eval_orbit_batch(self.cfg, split, device)


def _register_lazy(name, path, attr):
    @gt.register(name)
    class _Lazy:  # noqa: N801
        def __new__(cls, *a, **kw):
            import importlib

            mod = importlib.import_module(path, package=__package__)
            return getattr(mod, attr)(*a, **kw)

    _Lazy.__name__ = attr
    return _Lazy


_register_lazy("ipa-guidance", ".guidance.ipa", "AHDSGuidance")
_register_lazy("ipa-prompt-processor", ".guidance.prompts",
               "make_prompt_embeddings")
_register_lazy("gaussianip-system", ".system.stage1", "init_train_state")
