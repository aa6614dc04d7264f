"""The port's ``entry()``, the twin of the JAX package's
``__graft_entry__.entry``: the flagship YOLO-OBB forward step at 320 with
``max_det`` 16, its example frame the same seeded one, on the CPU when
asked and on cuda:0 by default."""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.entry import entry


def test_entry_runs_the_flagship_step_on_the_cpu():
    fn, (model, image) = entry("cpu")
    assert (model.task, model.size, model.num_classes) == ("obb", "n", 15)
    assert sum(p.numel() for p in model.parameters()) == 3085424  # YOLOv8n-obb, 15 classes
    want = np.random.default_rng(0).integers(0, 255, (1, 320, 320, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image.numpy(), want)  # __graft_entry__'s example frame
    out = fn(model, image)
    assert set(out) == {"xyxy", "score", "cls", "valid", "angle"}
    assert out["xyxy"].shape == (1, 16, 4) and out["valid"].shape == (1, 16)
    assert out["valid"].any() and torch.isfinite(out["xyxy"]).all()


def test_entry_wants_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
