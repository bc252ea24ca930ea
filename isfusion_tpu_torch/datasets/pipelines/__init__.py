from .compose import Compose
from .dbsampler import MMDataBaseSamplerV2
from .formating import (Collect3D, Collect3DV2, DefaultFormatBundle3D,
                        pad_to)
from .loading import (LoadAnnotations3D, LoadMultiViewImageFromFilesV2,
                      LoadPointsFromFile, LoadPointsFromMultiSweeps)
from .test_time_aug import MultiScaleFlipAug3D
from .transforms_3d import (GlobalRotScaleTrans, GlobalRotScaleTransV2,
                            ImageAug3D, ImageNormalize, ModalMask3D,
                            ObjectNameFilter, ObjectRangeFilter,
                            ObjectSampleV2, PointSample, PointShuffle,
                            PointsRangeFilter, RandomFlip3D, RandomFlip3DV2)

__all__ = ["Compose", "MMDataBaseSamplerV2", "Collect3D", "Collect3DV2",
           "DefaultFormatBundle3D", "pad_to", "LoadAnnotations3D",
           "LoadMultiViewImageFromFilesV2", "LoadPointsFromFile",
           "LoadPointsFromMultiSweeps", "MultiScaleFlipAug3D",
           "GlobalRotScaleTrans", "GlobalRotScaleTransV2", "ImageAug3D",
           "ImageNormalize", "ModalMask3D", "ObjectNameFilter",
           "ObjectRangeFilter", "ObjectSampleV2", "PointSample",
           "PointShuffle", "PointsRangeFilter", "RandomFlip3D",
           "RandomFlip3DV2"]
