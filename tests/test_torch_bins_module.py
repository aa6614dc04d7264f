"""The port's bins module (``modules/bins.py``) against the JAX package's on
the CPU: the device chain on the same 720p frames, the host leg's
``shm.bins_pose`` write, the host contour copy, and the real module loop
over the frame bus.

Tolerances: the cleaned mask and the overlay bit-exact (measured: the
overlay's two products and sum round alike in both packages: XLA does not
contract them here and torch runs them as separate operations); keypoints
equal; the pose quad within 1 px, matches and inliers equal.

Shared state: the JAX module's ``shm.bins_pose`` is pointed at a group of
this test's own, the port's runs under a ``CUAUV_SHM_NAMESPACE`` of its own
(``auv_shm_bins_pose@<namespace>``), so no other test's group is written;
only the groups and blocks made here are removed."""

import math
import threading
import time
import uuid

import jax
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)
from test_torch_private_shm import opened_within

from cuauv_vision_pipeline_tpu.capture_sources.synthetic import bin_texture, bins_frame
from cuauv_vision_pipeline_tpu.core import shm as jshm
from cuauv_vision_pipeline_tpu.core.base import DeviceResultMeta as JMeta
from cuauv_vision_pipeline_tpu.modules import bins as jbins
from cuauv_vision_pipeline_tpu.utils import contours as jcontours
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import Synthetic
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core.base import DeviceResultMeta
from cuauv_vision_pipeline_tpu_torch.core.log import log
from cuauv_vision_pipeline_tpu_torch.modules import bins as tbins
from cuauv_vision_pipeline_tpu_torch.ops.color import bgr_to_hsv
from cuauv_vision_pipeline_tpu_torch.ops.cuda.morph_kernel import fused_morph
from cuauv_vision_pipeline_tpu_torch.ops.threshold import in_range
from cuauv_vision_pipeline_tpu_torch.utils import contours as tcontours
from cuauv_vision_pipeline_tpu_torch.utils.draw import Color

FIELDS = ("visible", "matches", "inliers", "quad_x1", "quad_y1", "quad_x2", "quad_y2",
          "quad_x3", "quad_y3", "quad_x4", "quad_y4", "center_x", "center_y", "seq_frames")


@pytest.fixture
def pose_groups(monkeypatch):
    """Pose on (the builtin template); each package's bins_pose group is
    private to this test."""
    monkeypatch.setenv("CUAUV_BINS_POSE_TEMPLATE", "builtin")
    monkeypatch.setenv("CUAUV_SIFT_DETECTOR", "device")
    name = f"test_bins_pose_{uuid.uuid4().hex[:10]}"
    jgroup = jshm.define_group(name, jshm.DEFAULT_GROUPS["bins_pose"])
    monkeypatch.setattr(jshm, "bins_pose", jgroup, raising=False)
    monkeypatch.setenv(tshm.NAMESPACE_ENV, uuid.uuid4().hex[:10])
    yield jgroup, tshm.bins_pose
    jshm.delete_group(name)
    tshm.delete_group("bins_pose")


@pytest.fixture
def modules(pose_groups):
    jm = jbins.BinDetector(video_sources=["forward"], tuners=[], argv=[])
    tm = tbins.BinDetector(video_sources=["forward"], tuners=[], argv=["--device", "cpu"])
    assert tm.device == torch.device("cpu") and tm._pose_sift is not None
    return jm, tm, pose_groups


def run_chains(jm, tm, frame):
    jr, jp = jm.bins_chain(jax.device_put(frame), tuners={}, want_posts=True)
    tr, tp = tm.bins_chain(torch.from_numpy(frame), tuners={}, want_posts=True)
    cvt = lambda d, f: {k: f(v) for k, v in d.items()}  # noqa: E731
    return (cvt(jr, np.asarray), cvt(jp, np.asarray)), (cvt(tr, torch.Tensor.numpy), cvt(tp, torch.Tensor.numpy))


@pytest.mark.parametrize("t", [0.0, 1.0, 2.5, 4.0])
def test_bins_chain_matches_jax(modules, t):
    jm, tm, _ = modules
    (jr, jp), (tr, tp) = run_chains(jm, tm, bins_frame((720, 1280), t))
    assert set(tr) == set(jr) == {"cleaned", "kp", "pose_d2", "pose_idx"}
    np.testing.assert_array_equal(tr["cleaned"], jr["cleaned"])
    np.testing.assert_array_equal(tp["overlay"], jp["overlay"])
    np.testing.assert_array_equal(tr["kp"], jr["kp"])
    nq = tm._pose_sift.sources["bin"]["des_prep"][1]
    np.testing.assert_array_equal(tr["pose_idx"][:nq], jr["pose_idx"][:nq])
    np.testing.assert_allclose(tr["pose_d2"][:nq], jr["pose_d2"][:nq], rtol=1e-4, atol=1e-5)


def test_on_device_result_writes_the_jax_fields(modules):
    """Host leg: contours, rectangles, ratio test and RANSAC, one
    ``bins_pose`` write per frame; the same fields as the JAX module's, a
    visible pose with >= 8 inliers on the pasted plate (the JAX test's own
    check), and a bins post with the drawn overlay."""
    jm, tm, (jgroup, tgroup) = modules
    frame = bins_frame((720, 1280), 1.0)
    (jr, jp), (tr, tp) = run_chains(jm, tm, frame)
    posted = {}
    jm.post = lambda name, image: posted.__setitem__(("jax", name), np.array(image))
    tm.post = lambda name, image: posted.__setitem__(("port", name), np.array(image))
    jm.on_device_result(jr, jp, JMeta(aliases=("forward",), acquisition_time=0, submit_time=0.0))
    tm.on_device_result(tr, tp, DeviceResultMeta(aliases=("forward",), acquisition_time=0, submit_time=0.0))
    j, g = jgroup.get(), tgroup.get()
    for field in FIELDS:
        assert getattr(g, field) == getattr(j, field), field
    assert g.visible and g.inliers >= 8 and g.seq_frames == 1
    th, tw = bin_texture().shape[:2]
    y0 = int((720 - th) * (0.5 + 0.35 * math.sin(0.5)))
    x0 = int((1280 - tw) * (0.5 + 0.35 * math.cos(0.7)))
    assert abs(g.quad_x1 - x0) < 12 and abs(g.quad_y1 - y0) < 12
    assert abs(g.quad_x3 - (x0 + tw)) < 12 and abs(g.quad_y3 - (y0 + th)) < 12
    np.testing.assert_array_equal(posted[("port", "bins")], posted[("jax", "bins")])


def test_host_logic_draws_valid_rects():
    """on_device_result without pose: contour -> minAreaRect filtering
    (area > 500, aspect in [1, 3]) and the green rectangle on the overlay."""
    cleaned = np.zeros((120, 160), np.uint8)
    cleaned[30:70, 40:110] = 255  # 40x70: area 2800, aspect 1.75 -> valid
    cleaned[5:9, 5:9] = 255  # 4x4: area 16 -> filtered out
    overlay = np.zeros((120, 160, 3), np.uint8)
    overlay.setflags(write=False)  # packed-fetch views arrive read-only
    posted = []
    det = tbins.BinDetector.__new__(tbins.BinDetector)
    det.post = lambda name, image: posted.append((name, image))
    det.on_device_result({"cleaned": cleaned}, {"overlay": overlay}, meta=None)
    assert len(posted) == 1
    green = (posted[0][1] == np.array(Color.GREEN.value, np.uint8)).all(-1)
    ys, xs = np.nonzero(green)
    assert 25 <= ys.min() <= 35 and 35 <= xs.min() <= 45


def masks():
    rng = np.random.default_rng(8)
    out = {}
    for seed in range(4):
        noise = np.random.default_rng(seed).random((90, 120))
        out[f"noise_{seed}"] = (noise > 0.55).astype(np.uint8) * 255
    ring = np.zeros((64, 64), np.uint8)
    ring[8:56, 8:56] = 255
    ring[20:44, 20:44] = 0
    out["ring_with_hole"] = ring
    out["blobs"] = (rng.random((60, 80)) > 0.97).astype(np.uint8) * 255
    hsv = bgr_to_hsv(torch.from_numpy(bins_frame((720, 1280), 1.0)))
    mask = in_range(hsv, tbins.LOWER_BEIGE, tbins.UPPER_BEIGE)
    out["bins_mask_720p"] = fused_morph(mask, "open").numpy()
    return out


@pytest.mark.parametrize("external_only", [True, False], ids=["external", "with_holes"])
@pytest.mark.parametrize("name", list(masks()))
def test_contours_copy_matches_jax(name, external_only):
    mask = masks()[name]
    want = jcontours.find_contours(mask, external_only)
    got = tcontours.find_contours(mask, external_only)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        if len(g) >= 3:
            assert tcontours.min_area_rect(g) == jcontours.min_area_rect(w)


def test_template_path_without_pil_raises_clearly(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL":
            raise ImportError("no PIL")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="needs PIL"):
        tbins._load_template("/nonexistent/template.png")
    assert tbins._load_template("builtin").shape == (160, 320, 3)


def test_bins_module_binds_any_direction_and_posts(unique_direction, pose_groups):
    """The unmodified module's ``@device_fn("*")`` binds the first plane of
    a camera whatever its direction is named: port synthetic ``bins``
    source -> bus -> bins chain with pose (--device cpu) -> packed fetch ->
    host leg -> a ``bins`` post and ``shm.bins_pose`` advancing."""
    _, group = pose_groups
    source = Synthetic(unique_direction, width=640, height=360, fps=30, scene="bins")
    posted = []

    class Bins(tbins.BinDetector):
        def post(self, name, image, color_space="BGR"):
            posted.append((name, np.array(image)))

    module = Bins([unique_direction], [], fps=30, argv=["--device", "cpu"])
    src_thread = threading.Thread(target=source.run_event_loop)
    src_thread.start()
    time.sleep(0.3)
    quit_flag = threading.Event()
    try:
        with opened_within(module._module_manager):
            loop = threading.Thread(target=module._loop, args=(quit_flag, log.t))
            loop.start()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and (len(posted) < 2 or group.seq_frames.get() < 2):
                time.sleep(0.05)
            quit_flag.set()
            loop.join(timeout=20)
            assert not loop.is_alive()
    finally:
        source.quit_flag.set()
        src_thread.join(timeout=10)
    assert posted, "bins module never posted through the device path"
    name, overlay = posted[0]
    assert name == "bins" and overlay.shape == (360, 640, 3) and overlay.dtype == np.uint8
    assert group.seq_frames.get() >= 2
