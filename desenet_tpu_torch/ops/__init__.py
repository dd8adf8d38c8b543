from desenet_tpu_torch.ops.boxes import (
    bbox_ioa,
    box_iou,
    clip_coords,
    np_scale_coords,
    scale_coords,
    wh_iou,
    xyn2xy,
    xywh2xyxy,
    xywhn2xyxy,
    xyxy2xywh,
    xyxy2xywhn,
)
from desenet_tpu_torch.ops.nms import (
    MAX_WH,
    PRE_TOPK_PRODUCTION,
    PRE_TOPK_VAL,
    NMSOutput,
    batched_nms,
    non_max_suppression,
)
from desenet_tpu_torch.ops.resize import (
    adaptive_avg_pool,
    max_pool_same,
    resize_bilinear,
    resize_nearest,
    upsample_nearest,
)
# ``ops.c3_fused`` stays the module (its launch counter lives there)
from desenet_tpu_torch.ops.c3_fused import c3_params
from desenet_tpu_torch.ops.seg_pallas import upsample_argmax
from desenet_tpu_torch.ops.stem_pallas import stem_conv, stem_weight_matrix

__all__ = [
    "bbox_ioa",
    "box_iou",
    "clip_coords",
    "np_scale_coords",
    "scale_coords",
    "wh_iou",
    "xyn2xy",
    "xywh2xyxy",
    "xywhn2xyxy",
    "xyxy2xywh",
    "xyxy2xywhn",
    "MAX_WH",
    "PRE_TOPK_PRODUCTION",
    "PRE_TOPK_VAL",
    "batched_nms",
    "NMSOutput",
    "non_max_suppression",
    "adaptive_avg_pool",
    "max_pool_same",
    "resize_bilinear",
    "resize_nearest",
    "upsample_nearest",
    "upsample_argmax",
    "c3_params",
    "stem_conv",
    "stem_weight_matrix",
]
