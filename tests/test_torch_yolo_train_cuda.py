"""YOLO training on the card, each against the same work on the CPU.

* One train step (YOLOv8n detect at 128 px, batch 4, and YOLOv8n-obb with
  angles) on the card with TF32 off against the CPU from the same weights:
  loss within rtol 1e-5, every parameter gradient within 5e-3 of its norm,
  the BatchNorm running statistics within rtol 1e-4 (atol 1e-5).
* No host sync inside a step on device-resident inputs.
* ``train_step_entry()`` on cuda:0: a finite loss.
* ``examples.train_synthetic`` for a few steps on the card writes a
  checkpoint that ``YoloModel`` serves on the card.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_yolo_train_cuda.py
"""

import copy
import warnings

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.core.device import full_f32
from cuauv_vision_pipeline_tpu_torch.entry import train_step_entry
from cuauv_vision_pipeline_tpu_torch.examples import train_synthetic
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import create_model
from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import render_scene
from cuauv_vision_pipeline_tpu_torch.models.yolo.train import create_train_state, make_train_step

pytestmark = pytest.mark.cuda
S, B = 128, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def inputs(task, nc):
    rng = np.random.default_rng(1)
    parts = [rng.random((B, S, S, 3), np.float32), rng.random((B, 6, 4)).astype(np.float32) * S,
             rng.integers(-1, nc, (B, 6)).astype(np.int32)]
    if task == "obb":
        parts.append(rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, 6)).astype(np.float32))
    return parts


def one_step(model, device, parts):
    m = copy.deepcopy(model).to(device)
    step = make_train_step(create_train_state(m))
    with full_f32():
        loss = float(step(*(torch.from_numpy(p).to(device) for p in parts)))
    return (loss, {n: p.grad.cpu() for n, p in m.named_parameters()},
            {k: v.cpu() for k, v in m.state_dict().items() if "running" in k})


@pytest.mark.parametrize("task,nc", [("detect", 8), ("obb", 15)])
def test_one_step_card_equals_cpu(dev, task, nc):
    model = create_model(nc, "n", task, seed=3)
    parts = inputs(task, nc)
    want, got = one_step(model, "cpu", parts), one_step(model, dev, parts)
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    for name, g in want[1].items():
        assert (got[1][name] - g).abs().max() <= 5e-3 * g.norm(), name
    for key, v in want[2].items():
        torch.testing.assert_close(got[2][key], v, rtol=1e-4, atol=1e-5, msg=key)


def test_step_does_not_sync(dev):
    model = create_model(8, "n", "detect", seed=0).to(dev)
    step = make_train_step(create_train_state(model))
    parts = [torch.from_numpy(p).to(dev) for p in inputs("detect", 8)]
    step(*parts)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            loss = step(*parts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in caught if "called a synchronizing" in str(w.message)]
    assert loss.is_cuda and torch.isfinite(loss)


def test_train_step_entry_on_the_card(dev):
    assert np.isfinite(train_step_entry())


def test_example_checkpoint_serves_on_the_card(dev, tmp_path):
    out = str(tmp_path / "w.msgpack")
    run = train_synthetic.run(["--steps", "20", "--eval-scenes", "8", "--out", out])
    assert run["device"] == "cuda:0" and np.isfinite(run["loss"])
    serve = YoloModel(out, device=dev)
    decoded = serve.device_decode(render_scene(np.random.default_rng(0), size=128)[0])
    assert serve.image_size == 128 and decoded["valid"].is_cuda
