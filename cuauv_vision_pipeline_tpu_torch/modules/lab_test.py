#!/usr/bin/env python3
"""LAB channel visualization (reference modules/lab_test.py); port of
``cuauv_vision_pipeline_tpu.modules.lab_test``: the conversion runs on the
module's device (cuda:0 unless ``--device cpu``).

    python -m cuauv_vision_pipeline_tpu_torch.modules.lab_test forward [--device cpu]
"""

from ..core.base import ModuleBase
from ..utils.color import bgr_to_lab


class LabTest(ModuleBase):
    def process(self, direction, img):
        lab, (l, a, b) = bgr_to_lab(img, device=self.device)
        self.post("l", l, "GRAY")
        self.post("a", a, "GRAY")
        self.post("b", b, "GRAY")


if __name__ == "__main__":
    LabTest(["forward"], [])()
