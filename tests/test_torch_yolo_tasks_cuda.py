"""The rest of YOLO serving on the card: the pose, segment and classify
models and the quantized modes, each against the same call on the CPU.

* ``quant.int8_gemm_conv`` (im2col + ``torch._int_mm``) at the YOLO layers'
  odd shapes (K = 27, N = 1, 2, 15, 80, maps of fewer than 17 pixels),
  exactly equal to ``int8_conv_plain`` on the CPU.
* A w8a8 forward of YOLOv8n-seg on a 1080p frame: every int8 convolution
  exact against its plain version.
* The trained segment fixture in float32: ``valid``, ``cls`` and masks
  equal to the CPU's on four scenes, and one ``nms_fixed`` launch per
  frame.
* YOLOv8n-cls in float32: probabilities within 1e-7 of the CPU's.
* ``entry()`` on cuda:0 (TF32 off) against ``entry("cpu")``: ``valid`` and
  ``cls`` equal, ``xyxy`` within 1e-3 px and ``score`` within 1e-6 (a few
  float32 ulps at 320 px and near 0.5), one ``nms_fixed`` launch.
* The weight-only int8 mode keeps its int8 store on the host.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_yolo_tasks_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.core.device import full_f32
from cuauv_vision_pipeline_tpu_torch.entry import entry
from cuauv_vision_pipeline_tpu_torch.models.yolo import quant
from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import render_scene
from cuauv_vision_pipeline_tpu_torch.ops.cuda import nms_fixed_cuda

pytestmark = pytest.mark.cuda
SEG_FIXTURE = Path(__file__).resolve().parent / "fixtures" / "synth_pico_segment.msgpack"
GEMM_SHAPES = [(3, 16, 3, 2, 20, 24), (16, 1, 1, 1, 6, 5), (8, 2, 1, 1, 5, 7), (32, 15, 1, 1, 4, 4),
               (64, 80, 1, 1, 3, 3), (40, 24, 3, 1, 5, 6), (64, 64, 3, 1, 80, 80)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=[f"c{s[0]}_o{s[1]}_k{s[2]}_s{s[3]}_{s[4]}" for s in GEMM_SHAPES])
def test_int8_gemm_conv_equals_plain(dev, shape):
    c, o, k, s, h, w = shape
    qc = quant.Int8Conv(torch.nn.Conv2d(c, o, k, s, k // 2), torch.float32)
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-127, 128, (2, c, h, w), generator=g).to(torch.int8)
    want = quant.int8_conv_plain(x, qc.wq, s, k // 2)
    got = quant.int8_gemm_conv(x.to(dev).contiguous(memory_format=torch.channels_last), qc.wmat.to(dev), k, s,
                               k // 2, o)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def test_w8a8_forward_convs_exact(dev):
    model = YoloModel(None, task="segment", quantize="w8a8", device=dev)
    calls = []
    real = quant.int8_conv
    quant.int8_conv = lambda xq, conv: calls.append((xq, conv, real(xq, conv))) or calls[-1][2]
    try:
        out = model.device_decode(buoy_frame((1080, 1920), 0.4))
    finally:
        quant.int8_conv = real
    assert out["mask"].shape == (32, 160, 160) and out["mask"].device.type == "cuda"
    assert len(calls) == sum(isinstance(m, torch.nn.Conv2d) for m in model.model.modules())
    for xq, conv, acc in calls:
        assert torch.equal(acc.cpu(), quant.int8_conv_plain(xq.cpu(), conv.wq.cpu(), conv.stride, conv.padding))


def test_segment_fixture_f32_equals_cpu(dev):
    kw = dict(image_size=128, max_det=8, conf_thresh=0.25, half_precision=False)
    card, host = YoloModel(str(SEG_FIXTURE), device=dev, **kw), YoloModel(str(SEG_FIXTURE), device="cpu", **kw)
    rng = np.random.default_rng(77)
    n = 0
    for _ in range(4):
        img = render_scene(rng, size=128, max_objects=3)[0]
        before = nms_fixed_cuda.launches
        got = card.device_decode(img)
        assert nms_fixed_cuda.launches == before + 1
        want = host.device_decode(img)
        for key in ("valid", "cls", "mask"):
            assert torch.equal(got[key].cpu(), want[key]), key
        n += int(want["valid"].sum())
    assert n >= 4


def test_classify_f32_equals_cpu(dev):
    kw = dict(task="classify", image_size=224, class_names=[f"c{i}" for i in range(1000)], half_precision=False)
    card, host = YoloModel(None, device=dev, **kw), YoloModel(None, device="cpu", **kw)
    frame = buoy_frame((1080, 1920), 0.4)
    got, want = card.device_decode(frame)["probs"].cpu(), host.device_decode(frame)["probs"]
    assert got.shape == (1000,)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-7)


def test_entry_on_the_card_equals_the_cpu(dev):
    fn, (model, image) = entry()
    assert image.device == dev and next(model.parameters()).device == dev
    host_fn, host_args = entry("cpu")
    want = host_fn(*host_args)
    before = nms_fixed_cuda.launches
    with full_f32():
        got = fn(model, image)
    assert nms_fixed_cuda.launches == before + 1
    assert want["valid"].any()
    for key in ("valid", "cls"):
        assert torch.equal(got[key].cpu(), want[key]), key
    torch.testing.assert_close(got["xyxy"].cpu(), want["xyxy"], rtol=0, atol=1e-3)
    torch.testing.assert_close(got["score"].cpu(), want["score"], rtol=0, atol=1e-6)


def test_int8_store_stays_on_the_host(dev):
    model = YoloModel(None, task="obb", quantize="int8", image_size=320, device=dev)
    assert all(q.device.type == s.device.type == "cpu" for q, s in model._int8.values())
    assert all(p.device == dev for p in model.model.parameters())
    out = model.device_decode(buoy_frame((1080, 1920), 0.4))
    assert out["valid"].device == dev
