from desenet_tpu_torch.losses.detection import DetectionLoss, smooth_bce
from desenet_tpu_torch.losses.segmentation import segmentation_loss

__all__ = ["DetectionLoss", "smooth_bce", "segmentation_loss"]
