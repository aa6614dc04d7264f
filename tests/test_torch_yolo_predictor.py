"""The port's YoloModel end to end (letterbox, forward, decode, NMS,
summarize) against the JAX package's, on the trained detect fixture and four
``render_scene`` frames, on the CPU.

* float32: the same detections as JAX's float32 serving, boxes within
  1e-2 px and confidences within 1e-4.
* bf16 (the serving mode; BatchNorms folded into the convs in float32, then
  cast): recall >= 0.9 of JAX's float32 detections by ``match_detections``
  (IoU >= 0.5, same class).
"""

import os
import warnings

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo.predictor import YoloModel as JYoloModel
from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import match_detections, render_scene

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "synth_pico_detect.msgpack")
KW = dict(image_size=128, max_det=8, conf_thresh=0.25)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(77)
    return [render_scene(rng, size=128, max_objects=3)[0] for _ in range(4)]


@pytest.fixture(scope="module")
def jax_f32(frames):
    model = JYoloModel(FIXTURE, half_precision=False, **KW)
    return [{k: np.asarray(v) for k, v in model.device_decode(f).items()} for f in frames]


def test_f32_detections_equal_jax(frames, jax_f32):
    model = YoloModel(FIXTURE, half_precision=False, device="cpu", **KW)
    assert model.task == "detect" and model.class_names == ["disc", "slab"]
    assert model.device == torch.device("cpu") and model.dtype == torch.float32
    n = 0
    for frame, want in zip(frames, jax_f32):
        got = {k: v.numpy() for k, v in model.device_decode(frame).items()}
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["cls"], want["cls"])
        np.testing.assert_allclose(got["xyxy"], want["xyxy"], atol=1e-2)
        np.testing.assert_allclose(got["score"], want["score"], atol=1e-4)
        n += int(want["valid"].sum())
    assert n >= 4  # the fixture detects
    entries = model.predict(frames[0])
    assert [e["name"] for e in entries] == [model.class_names[c] for c in jax_f32[0]["cls"][jax_f32[0]["valid"]]]


def test_bf16_recall_of_jax_f32(frames, jax_f32):
    model = YoloModel(FIXTURE, device="cpu", **KW)
    assert model.dtype == torch.bfloat16
    tp = n_gt = 0
    for frame, want in zip(frames, jax_f32):
        got = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
               for k, v in model.device_decode(frame).items()}
        keep = want["valid"]
        t, g, _ = match_detections(got, want["xyxy"][keep], want["cls"][keep])
        tp, n_gt = tp + t, n_gt + g
    assert n_gt >= 4 and tp / n_gt >= 0.9, (tp, n_gt)


def test_batch_equals_single_frames(frames):
    model = YoloModel(FIXTURE, half_precision=False, device="cpu", **KW)
    batch = model.device_decode_batch(np.stack(frames))
    for lane, frame in enumerate(frames):
        single = model.device_decode(frame)
        for key, value in single.items():
            assert batch[key].shape[1:] == value.shape
            if value.is_floating_point():
                np.testing.assert_allclose(batch[key][lane].numpy(), value.numpy(), atol=1e-4)
            else:
                assert torch.equal(batch[key][lane], value), key


def test_track_adds_ids_and_missing_weight_serves_random_init(tmp_path):
    with pytest.warns(RuntimeWarning, match="RANDOM-INIT"):
        model = YoloModel(str(tmp_path / "absent.msgpack"), task="obb", size="p",
                          image_size=64, max_det=4, conf_thresh=0.0, device="cpu")
    img = np.random.default_rng(0).integers(0, 255, (48, 64, 3), np.uint8)
    results = model.track(img)[0].summary()
    assert len(results) == 4
    for r in results:
        assert set(r["box"]) == {"x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4"}
        assert "track_id" in r


def test_cuda_by_default_and_no_quantized_modes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings(), pytest.raises(RuntimeError, match="no CUDA device"):
        YoloModel(None, size="p")
    monkeypatch.setenv("CUAUV_YOLO_QUANT", "int4")  # int8 and w8a8 are served (quant.py)
    with pytest.raises(ValueError, match="unsupported quantize mode 'int4'"):
        YoloModel(None, size="p", device="cpu")


def test_f32_mode_turns_tf32_off_in_the_forward(monkeypatch):
    """Hopper's cuDNN takes TF32 for float32 convs by default; the exact-f32
    mode switches it (and matmul TF32) off for its forward and restores
    both after. The bf16 mode leaves them alone."""
    seen = []
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    for half in (False, True):
        model = YoloModel(FIXTURE, half_precision=half, device="cpu", **KW)
        forward = model.model.forward

        def spy(x, forward=forward):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return forward(x)

        monkeypatch.setattr(model.model, "forward", spy)
        model.device_decode(np.zeros((128, 128, 3), np.uint8))
        assert torch.backends.cudnn.allow_tf32 is True
    assert seen[0] == (False, False) and seen[1][0] is True


def test_decoded_dict_survives_the_packed_fetch(frames):
    """The module's chain result (decode dict + frame size) goes through the
    executor's one-copy packing (bools travel as 0/1 bytes and unpack as
    bools); summarize reads the unpacked dict as the decoded one."""
    from cuauv_vision_pipeline_tpu_torch.engine.executor import pack_result, unpack_result

    model = YoloModel(FIXTURE, half_precision=False, device="cpu", **KW)
    decoded = dict(model.device_decode(frames[0]))
    direct = model.summarize_decoded({k: v.numpy() for k, v in decoded.items()}, (128, 128))
    decoded["orig_h"] = torch.tensor(128, dtype=torch.int32)
    packed, spec = pack_result(decoded)
    back = unpack_result(packed.numpy(), spec)
    assert back["valid"].dtype == np.bool_ and int(back.pop("orig_h")) == 128
    assert model.summarize_decoded(back, (128, 128)) == direct and direct
