from bm2f_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from bm2f_tpu_torch.data.loader import build_train_loader, build_test_loader

__all__ = [
    "DatasetCatalog",
    "MetadataCatalog",
    "build_train_loader",
    "build_test_loader",
]
