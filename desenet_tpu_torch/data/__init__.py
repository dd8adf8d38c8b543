"""The data pipeline: ``create_mixed_dataloader`` (validation, and with
``augment=True`` training), the quad collate, the device stage and the
serving letterbox."""

from desenet_tpu_torch.data.augment import letterbox
from desenet_tpu_torch.data.dataset import (MixedDataset, collate,
                                            collate_quad, pad_det_targets)
from desenet_tpu_torch.data.loader import (DataLoader,
                                           create_mixed_dataloader, to_device)

__all__ = ["DataLoader", "MixedDataset", "collate", "collate_quad",
           "create_mixed_dataloader", "letterbox", "pad_det_targets",
           "to_device"]
