"""Each @device_fn's packed call replayed as a CUDA graph on the card,
through ``StreamExecutor`` with the module's own depth and async fetch,
against the same packed call run eagerly.

* ``BuoyLAB.buoy_chain`` (4 mapped lanes) and ``BuoyStereo.stereo_chain``
  on 32 seeded 1080p scenes (``benchmark/scenes.py``), twice round the
  ring: every result byte-equal to the eager call's (a replay whose packed
  vector were not copied out would hand the fetch thread the next
  dispatch's bytes), and every dispatch after the ``CAPTURE_AT``-th a replay.
* A tuner change mid-stream is a new key: captured again, results follow
  the new thresholds. ``want_posts=True`` replays with the right posts.
* A chain that reads a value on the host (``.item()``) falls back to eager
  for good, answers right, leaks no memory per failed key, and leaves the
  process able to capture the next chain.
* bins (HSV + morphology; with the device pose path), YOLO (one camera),
  and YOLO multicam (two cameras, and three through ``multicam_class``):
  eager-equal results; each prints whether it replays or falls back.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s tests/test_torch_executor_graph_cuda.py
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.engine.executor import (
    CAPTURE_AT,
    DevicePipeline,
    StreamExecutor,
    build_packed_fn,
)
from cuauv_vision_pipeline_tpu_torch.modules.red_buoy import BuoyLAB
from cuauv_vision_pipeline_tpu_torch.ops.cuda import launch_counts
from cuauv_vision_pipeline_tpu_torch.modules.red_buoy_stereo import BuoyStereo

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
H, W = 1080, 1920
SEED = 2_718_281_828


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scenes(mix: str, dev, n=32, seed=SEED) -> np.ndarray:
    """``n`` seeded 1080p scenes of a benchmark mix, on the host."""
    spec = importlib.util.spec_from_file_location("bench_scenes", ROOT / "benchmark" / "scenes.py")
    scenes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scenes)
    scene = json.loads((ROOT / "benchmark" / "traffic" / f"{mix}.json").read_text())["scene"]
    return scenes.make_scenes(n, H, W, scene, seed, dev).cpu().numpy()


def _tuners(tmin):
    return {"thresh_min": np.int32(tmin), "thresh_max": np.int32(255)}


def serve(fn, dispatches, tuners_of, want_posts=False, dev=None):
    """Run ``fn``'s @device_fn over ``dispatches`` (tuples of host arrays)
    as ModuleBase does; return the packed fn and, per dispatch, the served
    packed bytes and the eager call's bytes on the same arguments. The
    hand kernels' launch counts over the served dispatches are left in
    ``packed_fn.served_launches``."""
    lanes = fn._device_fn_batch
    packed_fn = build_packed_fn(fn, lanes, fn._device_fn_batch_mode)
    ex = StreamExecutor(DevicePipeline(packed_fn, dev), depth=fn._device_fn_depth,
                        async_fetch=fn._device_fn_async)
    served = []
    before = launch_counts()
    try:
        for i, args in enumerate(dispatches):
            served.extend(ex.submit(args, meta=i, tuners=tuners_of(i), want_posts=want_posts))
        served.extend(ex.flush())
    finally:
        ex.close()
    packed_fn.served_launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    assert [meta for _, meta in served] == list(range(len(dispatches)))
    out = []
    for ((packed, spec), i), args in zip(served, dispatches):
        eager, eager_spec = packed_fn._run(*(torch.from_numpy(a).to(dev) for a in args),
                                           tuners=tuners_of(i), want_posts=want_posts)
        assert spec == eager_spec, i
        out.append((packed, eager.cpu().numpy()))
    return packed_fn, out


def _assert_byte_equal(out):
    bad = [i for i, (got, want) in enumerate(out) if not np.array_equal(got, want)]
    assert not bad, f"dispatches {bad} differ from the eager call"


def _counts(n):
    """``graph_counts`` after ``n`` calls of one key that replays."""
    return {"eager": CAPTURE_AT - 1, "capture": 1, "replay": n - CAPTURE_AT, "fallback": 0}


def _report(name, packed_fn):
    print(f"graph_counts {name}: {json.dumps(packed_fn.graph_counts)}")


def test_buoy_chain_replays_byte_equal_to_eager_with_depth_2_and_async_fetch(dev):
    frames = _scenes("stream", dev)
    batches = [(np.ascontiguousarray(frames[i:i + 4]),) for i in range(0, 32, 4)] * 2
    packed_fn, out = serve(BuoyLAB.buoy_chain.__get__(BuoyLAB.__new__(BuoyLAB)), batches,
                           lambda i: _tuners(140), dev=dev)
    _report("buoy_chain", packed_fn)
    _assert_byte_equal(out)
    assert len({got.tobytes() for got, _ in out}) == 8  # the dispatches differ
    assert packed_fn.graph_counts == _counts(16)
    # a kernel launch a lane, counted where it runs: 16 dispatches and the
    # capture call's check (its replay is counted by the capture)
    assert packed_fn.served_launches == {"label_cuda": 4 * 17, "fused_morph": 4 * 17}


def test_stereo_chain_replays_byte_equal_to_eager(dev):
    frames = _scenes("stereo", dev)
    pairs = [(np.ascontiguousarray(frames[i]), np.ascontiguousarray(frames[i + 1]))
             for i in range(0, 32, 2)] * 2
    packed_fn, out = serve(BuoyStereo.stereo_chain.__get__(BuoyStereo.__new__(BuoyStereo)), pairs,
                           lambda i: _tuners(140), dev=dev)
    _report("stereo_chain", packed_fn)
    _assert_byte_equal(out)
    assert packed_fn.graph_counts == _counts(32)


def test_a_tuner_change_mid_stream_captures_again_and_follows_the_new_thresholds(dev):
    frames = _scenes("stream", dev, n=16)
    batches = [(np.ascontiguousarray(frames[i:i + 4]),) for i in range(0, 16, 4)] * 3
    tmin = [140] * 4 + [100] * 4 + [140] * 4
    packed_fn, out = serve(BuoyLAB.buoy_chain.__get__(BuoyLAB.__new__(BuoyLAB)), batches,
                           lambda i: _tuners(tmin[i]), dev=dev)
    _report("buoy_chain, tuner moved", packed_fn)
    _assert_byte_equal(out)
    # the same frames under the two thresholds give other answers
    assert [got.tobytes() for got, _ in out[:4]] != [got.tobytes() for got, _ in out[4:8]]
    assert [got.tobytes() for got, _ in out[:4]] == [got.tobytes() for got, _ in out[8:]]
    # 140 captured on its CAPTURE_AT-th call, 100 likewise, 140 kept: replays
    assert packed_fn.graph_counts == {"eager": 2 * (CAPTURE_AT - 1), "capture": 2,
                                      "replay": 12 - 2 * CAPTURE_AT, "fallback": 0}


def test_want_posts_replays_with_the_posts(dev):
    frames = _scenes("stream", dev, n=16)
    batches = [(np.ascontiguousarray(frames[i:i + 4]),) for i in range(0, 16, 4)] * 2
    packed_fn, out = serve(BuoyLAB.buoy_chain.__get__(BuoyLAB.__new__(BuoyLAB)), batches,
                           lambda i: _tuners(140), want_posts=True, dev=dev)
    _report("buoy_chain, posts", packed_fn)
    _assert_byte_equal(out)
    assert packed_fn.graph_counts == _counts(8)
    # the image post is the input itself: its bytes lead the posts' part
    assert all(frames[i % 4 * 4:i % 4 * 4 + 4].tobytes() in got.tobytes() for i, (got, _) in enumerate(out))


def test_a_chain_that_reads_a_value_on_the_host_falls_back_and_leaks_nothing(dev):
    def counting(f, *, tuners, want_posts):
        n = int((f > tuners["t"]).sum().item())  # waits for the card: cannot be captured
        return {"n": torch.full((), n, dtype=torch.int64, device=f.device)}

    counting._device_fn_batch, counting._device_fn_batch_mode = 1, "vmap"
    counting._device_fn_depth, counting._device_fn_async = 2, True
    rng = np.random.default_rng(3)
    frames = [(rng.integers(0, 256, (64, 96, 3), np.uint8),) for _ in range(6)]
    packed_fn, out = serve(counting, frames, lambda i: {"t": np.int32(100)}, dev=dev)
    _report("host read", packed_fn)
    _assert_byte_equal(out)
    for (got, _), (f,) in zip(out, frames):
        assert got.view(np.int64)[0] == int((f > 100).sum())
    assert packed_fn.graph_counts == {"eager": CAPTURE_AT - 1, "capture": 0, "replay": 0,
                                      "fallback": 7 - CAPTURE_AT}

    # a failed key keeps no memory: five more keys, each failing once (an
    # unreleased pool would hold its segments past empty_cache)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    for t in range(5):
        for _ in range(CAPTURE_AT):
            packed_fn(torch.from_numpy(frames[0][0]).to(dev), tuners={"t": np.int32(t)}, want_posts=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert packed_fn.graph_counts["fallback"] == 7 - CAPTURE_AT + 5
    assert torch.cuda.memory_reserved(dev) <= before

    # and the process still captures and replays the next chain
    test_stereo_chain_replays_byte_equal_to_eager(dev)


def _yolo(cls, dev):
    from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel

    inst = cls.__new__(cls)
    inst.model = YoloModel(device=dev)  # seeded random init, bf16, 640
    return inst


def _record(name, packed_fn, out):
    _report(name, packed_fn)
    _assert_byte_equal(out)
    counts = packed_fn.graph_counts
    assert counts["eager"] == CAPTURE_AT - 1 and sum(counts.values()) == len(out)


def test_bins_chain(dev):
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import bins_frame
    from cuauv_vision_pipeline_tpu_torch.modules.bins import BinDetector

    inst = BinDetector.__new__(BinDetector)
    frames = [(bins_frame((720, 1280), 0.3 * t),) for t in range(6)]
    packed_fn, out = serve(inst.bins_chain, frames, lambda i: {}, want_posts=True, dev=dev)
    _record("bins", packed_fn, out)


def test_bins_chain_with_the_device_pose_path(dev):
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import bin_texture, bins_frame
    from cuauv_vision_pipeline_tpu_torch.modules.bins import BinDetector
    from cuauv_vision_pipeline_tpu_torch.ops.color_np import bgr_to_gray_np
    from cuauv_vision_pipeline_tpu_torch.utils.sift import SIFT

    inst = BinDetector.__new__(BinDetector)
    inst._pose_detector = "device"
    inst._pose_sift = SIFT(detector="device", device=dev)
    inst._pose_sift.add_source("bin", bgr_to_gray_np(np.asarray(bin_texture())))
    inst._pose_sift.warm()
    frames = [(bins_frame((720, 1280), 0.3 * t),) for t in range(6)]
    packed_fn, out = serve(inst.bins_chain, frames, lambda i: {}, dev=dev)
    _record("bins with pose", packed_fn, out)


def test_yolo_detect_chain(dev):
    from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
    from cuauv_vision_pipeline_tpu_torch.modules.yolo import Yolo

    inst = _yolo(Yolo, dev)
    frames = [(buoy_frame((H, W), 0.4 * t),) for t in range(6)]
    packed_fn, out = serve(inst.detect_chain, frames, lambda i: {}, dev=dev)
    _record("yolo", packed_fn, out)
    if packed_fn.graph_counts["replay"]:  # one NMS a frame, counted as it runs
        assert packed_fn.served_launches == {"nms_fixed": len(out) + 1}


@pytest.mark.parametrize("cameras", [2, 3])
def test_yolo_multicam_detect_chain(dev, cameras):
    from cuauv_vision_pipeline_tpu_torch.modules.yolo_multicam import YoloMulticam, multicam_class

    cls = YoloMulticam if cameras == 2 else multicam_class(("zed[forward]", "flir[downward]", "aux[forward]"))
    inst = _yolo(cls, dev)
    rng = np.random.default_rng(cameras)
    sizes = [(720, 1280), (600, 800), (480, 640)][:cameras]
    frames = [tuple(rng.integers(0, 256, s + (3,), np.uint8) for s in sizes) for _ in range(6)]
    packed_fn, out = serve(inst.detect_chain, frames, lambda i: {}, want_posts=True, dev=dev)
    _record(f"yolo_multicam x{cameras}", packed_fn, out)
