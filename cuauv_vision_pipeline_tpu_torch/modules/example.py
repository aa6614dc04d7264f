#!/usr/bin/env python3
"""Minimal example module (reference modules/example.py); port of
``cuauv_vision_pipeline_tpu.modules.example`` (host only).

    python -m cuauv_vision_pipeline_tpu_torch.modules.example forward
"""

from ..core.base import ModuleBase, sources
from ..core.tuners import IntTuner
from ..utils.draw import Color, draw_text

module_tuners = [IntTuner("brightness", 0, -100, 100)]


class Example(ModuleBase):
    @sources("forward")
    def handle(self, img):
        import numpy as np

        shifted = np.clip(
            img.astype(np.int16) + self.tuners["brightness"], 0, 255
        ).astype(np.uint8)
        draw_text(shifted, "example", (10, 30), 1.0, Color.YELLOW)
        self.post("example", shifted)


if __name__ == "__main__":
    Example(["forward"], module_tuners)()
