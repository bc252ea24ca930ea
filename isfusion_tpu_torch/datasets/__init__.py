from .builder import build_dataloader, build_dataset, collate_batch
from .custom_3d import Custom3DDataset
from .dataset_wrappers import CBGSDataset
from .nuscenes_dataset import NuScenesDataset
from .nuscenes_mono_dataset import NuScenesMonoDataset

__all__ = ["build_dataloader", "build_dataset", "collate_batch",
           "Custom3DDataset", "CBGSDataset", "NuScenesDataset",
           "NuScenesMonoDataset"]
