from desenet_tpu_torch.eval.validator import (Validator, np_xywh2xyxy,
                                              seg_metrics, seg_validation)

__all__ = ["Validator", "np_xywh2xyxy", "seg_metrics", "seg_validation"]
