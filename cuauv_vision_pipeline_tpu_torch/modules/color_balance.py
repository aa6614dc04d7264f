#!/usr/bin/env python3
"""Color-balance module: posts original and corrected frames side by side.

Port of ``cuauv_vision_pipeline_tpu.modules.color_balance`` (reference
modules/color_balance.py:93-140): the correction engine of ``ops/balance.py``
on the module's device (``--device N|cpu``, cuda:0 by default), with a live
tuner for each stage. The tuners choose which stages run, so each flag
combination gets its own executor: a depth-1 async ``StreamExecutor``, so the
fetch of frame N overlaps the upload and kernels of frame N+1, and posts
arrive one frame late. There is nothing to compile (no ``prewarm``);
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
        self._execs = {}
        self._last_exec = None
        self._module_manager.set_staging_depth(2)

    def _config(self) -> BalanceConfig:
        return BalanceConfig(**{
            name: (int if name.endswith("_blocks") else bool)(self.tuners[name])
            for name in BalanceConfig._fields
        })

    def _exec_for(self, cfg: BalanceConfig) -> StreamExecutor:
        ex = self._execs.get(cfg)
        if ex is None:
            ex = StreamExecutor(
                DevicePipeline(lambda img, c=cfg: balance(img, c), self.device),
                depth=1,
                async_fetch=True,
            )
            self._execs[cfg] = ex
        return ex

    def _post_pair(self, balanced, original) -> None:
        self.post("original", original)
        self.post("balanced", balanced)

    def process(self, direction, img):
        ex = self._exec_for(self._config())
        if self._last_exec is not None and self._last_exec is not ex:
            for balanced, original in self._last_exec.flush():
                self._post_pair(balanced, original)
        self._last_exec = ex
        # meta carries a copy of the original frame (the bus staging view
        # is recycled) so the original/balanced pair posts together
        for balanced, original in ex.submit((img,), meta=img.copy()):
            self._post_pair(balanced, original)


if __name__ == "__main__":
    ColorBalance(["forward"], module_tuners)()
