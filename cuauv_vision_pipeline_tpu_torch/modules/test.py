#!/usr/bin/env python3
"""Hello-world diagnostic module (reference modules/test.py); port of
``cuauv_vision_pipeline_tpu.modules.test`` (host only).

    python -m cuauv_vision_pipeline_tpu_torch.modules.test forward
"""

from ..core.base import ModuleBase
from ..utils.draw import Color, draw_text


class TestModule(ModuleBase):
    def process(self, direction, img):
        draw_text(img, f"hello from {direction}", (20, 40), 1.0, Color.GREEN)
        self.post("hello", img)


if __name__ == "__main__":
    TestModule(["forward"], [])()
