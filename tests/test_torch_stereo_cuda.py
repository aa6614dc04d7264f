"""The multi-camera paths on the card: the stereo chain, the one-card
fan-out, the cross-camera merge and the two-camera YOLO dispatch, each
against the same call on the CPU, with the launches each must make.

* ``BuoyStereo.stereo_chain`` on two 1080p eyes: one ``label_cuda_batched``
  and one ``fused_morph`` launch per call; masks, cleaned masks, found and
  area equal to the CPU's, centroid within 1e-3 px.
* ``fanout.make_fanout`` on 4 frames: one launch of each for the 4.
* ``crosscam.cross_camera_nms``: one ``nms_fixed`` launch, rows equal.
* ``YoloModel.device_decode_multi`` (two cameras): one ``nms_fixed``
  launch per dispatch.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stereo_cuda.py
"""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.modules.red_buoy_stereo import BuoyStereo
from cuauv_vision_pipeline_tpu_torch.ops.cuda import launch_counts
from cuauv_vision_pipeline_tpu_torch.parallel.crosscam import cross_camera_nms
from cuauv_vision_pipeline_tpu_torch.parallel.fanout import make_fanout

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _launched(fn):
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}


def _tuners(tmin):
    return {"thresh_min": np.int32(tmin), "thresh_max": np.int32(255)}


@pytest.mark.parametrize("tmin", [140, 0])
def test_stereo_chain_launches_the_batched_ccl_once(dev, tmin):
    eyes = [buoy_frame((1080, 1920), t) for t in (0.4, 1.2)]
    (got, got_posts), launched = _launched(lambda: BuoyStereo.stereo_chain(
        None, *(torch.from_numpy(e).to(dev) for e in eyes), tuners=_tuners(tmin), want_posts=True))
    assert launched == {"label_cuda_batched": 1, "fused_morph": 1}
    want, want_posts = BuoyStereo.stereo_chain(None, *(torch.from_numpy(e) for e in eyes),
                                               tuners=_tuners(tmin), want_posts=True)
    for key in want_posts:
        assert torch.equal(got_posts[key].cpu(), want_posts[key]), key
    assert torch.equal(got["found"].cpu(), want["found"]) and bool(want["found"].all())
    assert torch.equal(got["area"].cpu(), want["area"])
    torch.testing.assert_close(got["centroid"].cpu(), want["centroid"], rtol=1e-5, atol=1e-3)


def test_fanout_is_one_batched_chain(dev):
    frames = np.stack([buoy_frame((540, 960), 0.7 * i) for i in range(4)])
    got, launched = _launched(lambda: make_fanout(dev)(frames, 140, 255))
    assert launched == {"label_cuda_batched": 1, "fused_morph": 1}
    want = make_fanout("cpu")(frames, 140, 255)
    assert torch.equal(got["area"].cpu(), want["area"]) and torch.equal(got["bbox"].cpu(), want["bbox"])
    torch.testing.assert_close(got["centroid"].cpu(), want["centroid"], rtol=1e-5, atol=1e-3)


def test_cross_camera_nms_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(5)
    dets = np.zeros((2, 32, 6), np.float32)
    xy = rng.uniform(0, 0.8, (2, 24, 2))
    dets[:, :24, :2] = xy
    dets[:, :24, 2:4] = xy + rng.uniform(0.02, 0.2, (2, 24, 2))
    dets[:, :24, 4] = rng.uniform(0.05, 1.0, (2, 24))
    dets[:, :24, 5] = rng.integers(0, 3, (2, 24))
    got, launched = _launched(lambda: cross_camera_nms(torch.from_numpy(dets).to(dev)))
    assert launched == {"nms_fixed": 1}
    assert torch.equal(got.cpu(), cross_camera_nms(torch.from_numpy(dets)))


def test_device_decode_multi_launches_one_nms(dev):
    from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel

    model = YoloModel(None, task="obb", image_size=320, device=dev)
    cams = [torch.from_numpy(buoy_frame(hw, 0.5)).to(dev) for hw in ((720, 1280), (600, 800))]
    decoded, launched = _launched(lambda: model.device_decode_multi(cams))
    assert launched == {"nms_fixed": 1}
    assert all(v.shape[0] == 2 for v in decoded.values())
