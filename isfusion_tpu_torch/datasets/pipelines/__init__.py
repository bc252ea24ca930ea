from .compose import Compose
from .formating import Collect3D, DefaultFormatBundle3D, pad_to
from .loading import LoadAnnotations3D, LoadPointsFromFile
from .transforms_3d import (GlobalRotScaleTrans, ObjectNameFilter,
                            ObjectRangeFilter, PointSample, PointShuffle,
                            PointsRangeFilter, RandomFlip3D)

__all__ = ["Compose", "Collect3D", "DefaultFormatBundle3D", "pad_to",
           "LoadAnnotations3D", "LoadPointsFromFile", "GlobalRotScaleTrans",
           "ObjectNameFilter", "ObjectRangeFilter", "PointSample",
           "PointShuffle", "PointsRangeFilter", "RandomFlip3D"]
