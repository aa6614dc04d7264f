#!/usr/bin/env python3
"""Color-balance module: posts original and corrected frames side by side.

Port of ``cuauv_vision_pipeline_tpu.modules.color_balance`` (reference
modules/color_balance.py:93-140): the correction engine of ``ops/balance.py``
on the module's device (``--device N|cpu``, cuda:0 by default), with a live
tuner for each stage. One depth-1 async ``StreamExecutor`` serves the
module's life: each frame's ``BalanceConfig`` goes with its submit, so a
tuner change costs nothing and the executor's queue keeps the posts in
order. The fetch of frame N overlaps the upload and kernels of frame N+1, so
the ``original``/``balanced`` pairs arrive one frame late, in frame order
across a tuner change. There is nothing to compile (no ``prewarm``);
``DevicePipeline.warmup`` takes first-use costs where a caller wants them.

    python -m cuauv_vision_pipeline_tpu_torch.modules.color_balance forward [--device N|cpu]
"""

from __future__ import annotations

from ..core.base import ModuleBase
from ..core.tuners import BoolTuner, IntTuner
from ..engine.executor import DevicePipeline, StreamExecutor
from ..ops.balance import BalanceConfig, balance

module_tuners = [
    BoolTuner("equalize_rgb", True),
    BoolTuner("rgb_contrast_correct", False),
    BoolTuner("hsv_contrast_correct", False),
    BoolTuner("hsi_contrast_correct", True),
    BoolTuner("rgb_extrema_clipping", True),
    BoolTuner("adaptive_cast_correction", False),
    IntTuner("horizontal_blocks", 1, 1, 16),
    IntTuner("vertical_blocks", 1, 1, 16),
]


class ColorBalance(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._executor = StreamExecutor(DevicePipeline(balance, self.device), depth=1, async_fetch=True)
        self._module_manager.set_staging_depth(2)

    def _config(self) -> BalanceConfig:
        return BalanceConfig(**{
            name: (int if name.endswith("_blocks") else bool)(self.tuners[name])
            for name in BalanceConfig._fields
        })

    def _post_pair(self, balanced, original) -> None:
        self.post("original", original)
        self.post("balanced", balanced)

    def process(self, direction, img):
        # meta carries a copy of the original frame (the bus staging view
        # is recycled) so the original/balanced pair posts together
        for balanced, original in self._executor.submit((img,), meta=img.copy(), cfg=self._config()):
            self._post_pair(balanced, original)


if __name__ == "__main__":
    ColorBalance(["forward"], module_tuners)()
