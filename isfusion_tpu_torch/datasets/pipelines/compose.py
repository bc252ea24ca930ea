"""Pipeline composition (counterpart of
``isfusion_tpu/datasets/pipelines/compose.py``; mmcv Compose, epoch-aware)."""
from __future__ import annotations

from typing import List, Optional

from ...registry import PIPELINES, build_from_cfg


class Compose:
    def __init__(self, transforms: List):
        self.transforms = [build_from_cfg(dict(t), PIPELINES)
                           if isinstance(t, dict) else t for t in transforms]

    def set_epoch(self, epoch: int) -> None:
        """Propagate the epoch to epoch-scheduled transforms."""
        for t in self.transforms:
            if hasattr(t, "set_epoch"):
                t.set_epoch(epoch)

    def __call__(self, data: Optional[dict]) -> Optional[dict]:
        for t in self.transforms:
            data = t(data)
            if data is None:
                return None
        return data
