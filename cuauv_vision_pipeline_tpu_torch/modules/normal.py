#!/usr/bin/env python3
"""Normal-map sampler: running average of the normal at a tunable point.

Port of ``cuauv_vision_pipeline_tpu.modules.normal``: the decode runs on the
module's device (cuda:0 unless ``--device cpu``). Parity target: reference
modules/normal.py:16-43 — decode the u8 normal plane to [-1, 1], sample at
(x, y) tuners, keep a running average, draw a marker, post.

    python -m cuauv_vision_pipeline_tpu_torch.modules.normal normal [--device cpu]
"""

from __future__ import annotations

from ..core import tuners
from ..core.base import ModuleBase
from ..utils.draw import draw_circle
from ..utils.transform import decode_normal

module_options = [
    tuners.IntTuner("x", 400, 0, 720),
    tuners.IntTuner("y", 400, 0, 1280),
]


class Normal(ModuleBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.x = self.y = self.z = 0.0
        self.count = 0

    def reset(self):
        self.x = self.y = self.z = 0.0
        self.count = 0

    def process(self, direction, img):
        decoded = decode_normal(img, device=self.device)
        coord_x = self.tuners["x"]
        coord_y = self.tuners["y"]
        if coord_x >= img.shape[0] or coord_y >= img.shape[1]:
            return
        x, y, z = decoded[coord_x, coord_y][:3]

        self.count += 1
        self.x += (x - self.x) / self.count
        self.y += (y - self.y) / self.count
        self.z += (z - self.z) / self.count
        print(self.x, self.y, self.z)

        annotated = img.copy()
        draw_circle(annotated, (coord_y, coord_x), 10, thickness=10)
        self.post("point", annotated)


if __name__ == "__main__":
    Normal(["normal"], module_options)()
