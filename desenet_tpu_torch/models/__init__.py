import os

from desenet_tpu_torch.models.build import (DeSeNet, ModelSpec, build_model,
                                            init_weights, mask_coefficients,
                                            parse_config, require_seg_head)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


def config_path(name: str) -> str:
    """Resolve a bundled model config by name (e.g. 'yolov5s_seg') or pass
    an existing path through."""
    if os.path.exists(name):
        return name
    p = os.path.join(CONFIG_DIR,
                     name if name.endswith(".json") else name + ".json")
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"model config {name!r} not found (looked in {CONFIG_DIR})")
    return p


__all__ = [
    "DeSeNet",
    "ModelSpec",
    "build_model",
    "init_weights",
    "mask_coefficients",
    "parse_config",
    "config_path",
    "require_seg_head",
]
