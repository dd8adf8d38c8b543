"""The validation data pipeline (``create_mixed_dataloader`` with
``augment=False``) and the serving letterbox."""

from desenet_tpu_torch.data.augment import letterbox
from desenet_tpu_torch.data.dataset import MixedDataset, pad_det_targets
from desenet_tpu_torch.data.loader import DataLoader, create_mixed_dataloader

__all__ = ["DataLoader", "MixedDataset", "create_mixed_dataloader",
           "letterbox", "pad_det_targets"]
