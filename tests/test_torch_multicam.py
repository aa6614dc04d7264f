"""The port's multi-camera YOLO against the JAX package's, on the CPU.

* ``parallel.crosscam``: ``cross_camera_nms`` with padding rows (conf <= 0,
  never picked) equal to JAX's on the same stacked lists; the one-card
  ``make_cross_camera_merge`` equal, camera by camera, to JAX's mesh merge
  on the 8-device CPU mesh.
* ``modules.yolo_multicam._merged_dets`` on mixed resolutions (zed 720p +
  flir 600p letterboxes): the same consensus list as JAX, within 1e-6 (the
  un-letterbox divides differ by rounding at most).
* ``YoloModel.device_decode_multi`` in float32 on weights carried across
  (the trained detect fixture through ``models/yolo/weights.py``; an obb
  tree redrawn from a seeded numpy generator, through ``params_from_flax``):
  valid and cls equal to JAX's, boxes within 1e-2 px, scores within 1e-4;
  each camera's lane equals that camera decoded alone; per-camera summaries
  equal JAX's.
* ``YoloMulticam`` (two cameras) and ``multicam_class`` (three) as in the
  JAX module tests: one batched dispatch, per-camera direction gating,
  posts and track spaces, ``shm.yolo_status`` -- on a shm namespace of this
  test's own.
"""

import time
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo.predictor import YoloModel as JYoloModel
from cuauv_vision_pipeline_tpu.modules import yolo_multicam as jmulticam
from cuauv_vision_pipeline_tpu.parallel import crosscam as jcrosscam
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core.base import DeviceResultMeta
from cuauv_vision_pipeline_tpu_torch.core.handlers import HandlerMixin
from cuauv_vision_pipeline_tpu_torch.handlers.bins import BinsOBB
from cuauv_vision_pipeline_tpu_torch.handlers.gate import GateOBB
from cuauv_vision_pipeline_tpu_torch.handlers.gate_behind import GateBehindOBB
from cuauv_vision_pipeline_tpu_torch.handlers.manipulator import ManipulatorOBB
from cuauv_vision_pipeline_tpu_torch.handlers.slalom import SlalomOBB
from cuauv_vision_pipeline_tpu_torch.handlers.torpedoes import TorpedoesOBB
from cuauv_vision_pipeline_tpu_torch.models.yolo.data import MAP_FN
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import letterbox_params
from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import render_scene
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import params_from_flax
from cuauv_vision_pipeline_tpu_torch.modules import yolo_multicam as tmulticam
from cuauv_vision_pipeline_tpu_torch.parallel import crosscam as tcrosscam

FIXTURE = "tests/fixtures/synth_pico_detect.msgpack"
FIXTURE_KW = dict(image_size=128, max_det=8, conf_thresh=0.25)


def _crosscam_cases():
    out = {}
    dets = np.zeros((3, 4, 6), np.float32)  # rows 2-3 of each camera: padding
    for cam in range(3):
        dets[cam, 0] = (50, 50, 90, 90, 0.5 + 0.1 * cam, 0)  # one shared object
        dets[cam, 1] = (200 + 30 * cam, 10, 212 + 30 * cam, 22, 0.8, 1)
    out["shared_and_unique"] = dets
    rng = np.random.default_rng(5)
    dets = np.zeros((4, 16, 6), np.float32)
    xy = rng.uniform(0, 300, (4, 12, 2))
    wh = rng.uniform(10, 60, (4, 12, 2))
    dets[:, :12, :2] = xy
    dets[:, :12, 2:4] = xy + wh
    dets[:, :12, 4] = rng.uniform(0.05, 1.0, (4, 12))
    dets[:, :12, 5] = rng.integers(0, 3, (4, 12))
    dets[:, 12:, 4] = -1.0  # padding with a negative conf
    out["random_overflowing_max_det"] = dets
    out["all_padding"] = np.zeros((2, 5, 6), np.float32)
    return out


CROSSCAM = _crosscam_cases()


@pytest.mark.parametrize("case", list(CROSSCAM))
def test_cross_camera_nms_matches_jax(case):
    dets = CROSSCAM[case]
    got = tcrosscam.cross_camera_nms(torch.from_numpy(dets), max_det=8).numpy()
    want = np.asarray(jcrosscam.cross_camera_nms(jnp.asarray(dets), max_det=8))
    assert got.shape == (8, 6)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 4] >= 0).all()  # padding rows never picked
    if case == "shared_and_unique":
        kept = got[got[:, 4] > 0]
        assert len(kept) == 4 and kept[kept[:, 5] == 0][0, 4] == pytest.approx(0.7)


def test_cross_camera_merge_matches_jax_mesh():
    n = 8
    dets = np.zeros((n, 2, 6), np.float32)
    for cam in range(n):
        dets[cam, 0] = (10, 10, 30, 30, 0.4 + 0.05 * cam, 0)
        dets[cam, 1] = (40 * cam, 100, 40 * cam + 16, 116, 0.9, 1)
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    want = np.asarray(jcrosscam.make_cross_camera_merge(mesh, max_det=16)(
        jax.device_put(dets, NamedSharding(mesh, P("data")))))
    got = tcrosscam.make_cross_camera_merge("cpu", max_det=16)(dets).numpy()
    assert got.shape == want.shape == (n, 16, 6)
    np.testing.assert_array_equal(got, want)
    for cam in range(1, n):
        np.testing.assert_array_equal(got[cam], got[0])
    assert int((got[0, :, 4] > 0).sum()) == n + 1


def test_merged_dets_unletterboxes_mixed_resolutions():
    S = 640
    cam_hw = ((720, 1280), (600, 800))  # zed 720p + flir 600p
    shared_n = (0.05, 0.05, 0.20, 0.20)  # one object at the same normalized place
    unique_n = (0.70, 0.60, 0.80, 0.75)

    def to_model(box_n, hw):
        h, w = hw
        scale, left, top, _, _ = letterbox_params(h, w, S)
        x1, y1, x2, y2 = box_n
        return (x1 * w * scale + left, y1 * h * scale + top, x2 * w * scale + left, y2 * h * scale + top)

    K = 4
    xyxy = np.zeros((2, K, 4), np.float32)
    score = np.zeros((2, K), np.float32)
    cls = np.zeros((2, K), np.int32)
    xyxy[0, 0] = to_model(shared_n, cam_hw[0])
    score[0, 0] = 0.6
    xyxy[1, 0] = to_model(shared_n, cam_hw[1])
    score[1, 0] = 0.9
    xyxy[1, 1] = to_model(unique_n, cam_hw[1])
    score[1, 1] = 0.8
    cls[1, 1] = 1
    got = tmulticam._merged_dets({"xyxy": torch.from_numpy(xyxy), "score": torch.from_numpy(score),
                                  "cls": torch.from_numpy(cls)}, cam_hw, S).numpy()
    want = np.asarray(jmulticam._merged_dets({"xyxy": jnp.asarray(xyxy), "score": jnp.asarray(score),
                                              "cls": jnp.asarray(cls)}, cam_hw, S))
    np.testing.assert_allclose(got, want, atol=1e-6)
    kept = got[got[:, 4] > 0]
    assert len(kept) == 2
    shared = kept[kept[:, 5] == 0]
    assert len(shared) == 1 and shared[0, 4] == pytest.approx(0.9)
    np.testing.assert_allclose(shared[0, :4], shared_n, atol=0.02)


def _fixture_cameras():
    """Two cameras of different sizes: a 128 px scene, and the middle rows
    of another at twice the size (192x256, letterboxed back down). At these
    sizes the letterbox equals JAX's at the u8 level (at some toy sizes a
    few resized pixels round one level apart)."""
    rng = np.random.default_rng(77)
    a = render_scene(rng, size=128, max_objects=3)[0]
    b = render_scene(rng, size=128, max_objects=3)[0][16:112]
    return a, np.repeat(np.repeat(b, 2, axis=0), 2, axis=1)


def _redrawn_obb():
    """(JAX model, port model) of a YOLOv8p-obb whose every leaf was redrawn
    from a seeded numpy generator (init's logits are all ~0), f32."""
    names = ["a", "b", "c", "d"]
    jmodel = JYoloModel(None, task="obb", size="p", class_names=names, image_size=160,
                        half_precision=False, conf_thresh=0.25, max_det=8)
    rng = np.random.default_rng(0)

    def redraw(leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim == 4:  # HWIO kernels: unit output variance
            return rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:3])), leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    variables = jax.tree.map(redraw, jmodel.variables)
    jmodel._infer_vars = jax.tree.map(jnp.asarray, variables)
    model = YoloModel(None, task="obb", size="p", class_names=names, image_size=160,
                      half_precision=False, conf_thresh=0.25, max_det=8, device="cpu")
    model.model.load_state_dict(params_from_flax(variables, "obb"))
    model.to("cpu")
    return jmodel, model


@pytest.fixture(scope="module")
def models():
    out = {"fixture": (JYoloModel(FIXTURE, half_precision=False, **FIXTURE_KW),
                       YoloModel(FIXTURE, half_precision=False, device="cpu", **FIXTURE_KW),
                       _fixture_cameras())}
    rng = np.random.default_rng(3)
    out["redrawn_obb"] = (*_redrawn_obb(), (rng.integers(0, 256, (120, 160, 3), np.uint8),
                                            rng.integers(0, 256, (80, 100, 3), np.uint8)))
    return out


@pytest.mark.parametrize("case", ["fixture", "redrawn_obb"])
def test_device_decode_multi_matches_jax(models, case):
    jmodel, model, cams = models[case]
    got = {k: v.numpy() for k, v in model.device_decode_multi(cams).items()}
    want = {k: np.asarray(v) for k, v in jmodel.device_decode_multi(tuple(jnp.asarray(c) for c in cams)).items()}
    assert set(got) == set(want)
    assert all(v.shape[0] == 2 for v in got.values())
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["xyxy"], want["xyxy"], atol=1e-2)
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-4)
    if "angle" in want:
        np.testing.assert_allclose(got["angle"], want["angle"], atol=1e-4)
    assert int(got["valid"].sum()) >= 2  # something to compare
    for i, cam in enumerate(cams):
        alone = {k: v.numpy() for k, v in model.device_decode(cam).items()}
        for key, value in alone.items():
            if value.dtype.kind == "f":
                np.testing.assert_allclose(got[key][i], value, atol=1e-4, err_msg=key)
            else:
                np.testing.assert_array_equal(got[key][i], value, err_msg=key)
        mine = model.summarize_decoded({k: v[i] for k, v in got.items()}, cam.shape[:2])
        theirs = jmodel.summarize_decoded({k: v[i] for k, v in want.items()}, cam.shape[:2])
        assert [(d["name"], d["class"]) for d in mine] == [(d["name"], d["class"]) for d in theirs]
        for d, e in zip(mine, theirs):
            assert d["confidence"] == pytest.approx(e["confidence"], abs=1e-4)
            for k in d["box"]:
                assert d["box"][k] == pytest.approx(e["box"][k], abs=2e-2)


def test_device_decode_multi_launches_one_nms_for_all_cameras(models, monkeypatch):
    from cuauv_vision_pipeline_tpu_torch.models.yolo import decode as decode_mod

    _, model, cams = models["fixture"]
    calls = []
    real = decode_mod.nms_fixed_cuda
    monkeypatch.setattr(decode_mod, "nms_fixed_cuda", lambda *a: calls.append(a[1].shape) or real(*a))
    model.device_decode_multi(cams + cams[:1])
    assert len(calls) == 1 and calls[0][0] == 3  # [cameras, pool]


@pytest.fixture
def namespace(monkeypatch):
    """A shm namespace of this test's own: active_objects, yolo_status and
    the handlers' groups, removed afterwards."""
    monkeypatch.setenv(tshm.NAMESPACE_ENV, f"test-{uuid.uuid4().hex[:10]}")
    groups = ["active_objects", "yolo_status", "yolo_torpedoes", "yolo_slalom", "yolo_gate",
              "yolo_gate_behind", "yolo_bins", "yolo_manipulator"]
    yield
    for name in groups:
        tshm.delete_group(name)


def _module(cls, dispatched):
    """A multicam module without a bus: posts, tuners and normalisation
    stubbed as in the JAX module tests; handler calls recorded."""
    module = object.__new__(cls)
    posts = {}
    module.post = lambda name, img, cs="BGR": posts.__setitem__(name, img.shape)
    module._performance_enabled = False

    class Tuners(dict):
        def __getitem__(self, k):
            return 0.05

    module._module_manager = Tuners()
    module.normalize = lambda c: (c[0] / 160 - 0.5, c[1] / 160 - 0.5)
    module.normalize_axis = lambda c, a: c / 160 - 0.5
    module.get_latency = lambda: 0
    HandlerMixin.__init__(module, [TorpedoesOBB("torpedoes"), SlalomOBB("slalom"), GateOBB("gate"),
                                   GateBehindOBB("gate_behind"), BinsOBB("bins"),
                                   ManipulatorOBB("manipulator")])
    for name, handler in module.handlers.items():
        real = handler.process
        handler.process = (lambda real, name: lambda direction, img, *a: (
            dispatched.append((name, direction, img.shape)), real(direction, img, *a)))(real, name)
    module.model = YoloModel(None, task="obb", image_size=160, conf_thresh=0.0, max_det=8, device="cpu")
    module.yolo_model_type = module.model.task
    module.map_fn = MAP_FN[module.yolo_model_type]
    return module, posts


def _set_active(active):
    for flag in ("yolo_torpedoes_board", "yolo_slalom", "yolo_gate", "yolo_gate_behind", "yolo_bins",
                 "yolo_manipulator"):
        tshm.active_objects.set_field(flag, flag in active)
        if flag in active:
            tshm.active_objects.set_field(f"{flag}_direction", active[flag])


def _meta(aliases):
    return DeviceResultMeta(aliases=aliases, acquisition_time=int(time.monotonic() * 1000),
                            submit_time=time.monotonic())


def test_multicam_one_dispatch_two_cameras(namespace):
    dispatched = []
    module, posts = _module(tmulticam.YoloMulticam, dispatched)
    # torpedoes active on the forward camera, bins on the downward one
    _set_active({"yolo_torpedoes_board": "forward", "yolo_bins": "downward"})
    rng = np.random.default_rng(1)
    fwd = rng.integers(0, 255, (120, 160, 3), np.uint8)
    flir = rng.integers(0, 255, (80, 100, 3), np.uint8)
    decoded, chain_posts = module.detect_chain(torch.from_numpy(fwd), torch.from_numpy(flir), tuners={},
                                               want_posts=True)
    decoded = {k: v.numpy() for k, v in decoded.items()}
    chain_posts = {k: v.numpy() for k, v in chain_posts.items()}
    assert all(v.shape[0] == 2 for v in decoded.values())  # one batched dispatch
    assert module._cam_hw == ((120, 160), (80, 100))
    module.on_device_result(decoded, chain_posts, _meta(("forward", "flir")))
    assert posts["image_forward"] == fwd.shape and posts["image_downward"] == flir.shape
    assert ("torpedoes", "forward", fwd.shape) in dispatched
    assert ("bins", "downward", flir.shape) in dispatched
    assert len(dispatched) == 2  # every other detector inactive or on the other camera
    assert len(module._cam_trackers) == 2
    assert tshm.yolo_status.get().frames == 1
    # performance mode: nothing posted, the stand-in frame for handlers
    module._performance_enabled = True
    decoded, chain_posts = module.detect_chain(torch.from_numpy(fwd), torch.from_numpy(flir), tuners={},
                                               want_posts=False)
    assert chain_posts == {}
    module.on_device_result({k: v.numpy() for k, v in decoded.items()}, {}, _meta(("forward", "flir")))
    assert tshm.yolo_status.get().frames == 2


def test_multicam_factory_three_cameras(namespace):
    cls = tmulticam.multicam_class(["zed[forward]", "flir[downward]", "aux[forward]"])
    jcls = jmulticam.multicam_class(["zed[forward]", "flir[downward]", "aux[forward]"])
    assert cls.__name__ == jcls.__name__ == "YoloMulticam"  # shm block names stay stable
    assert cls.CAMERAS == jcls.CAMERAS
    assert cls.POST_NAMES == jcls.POST_NAMES == ("image_forward", "image_downward", "image_forward2")
    assert cls.detect_chain._device_fn_aliases == jcls.detect_chain._device_fn_aliases == ("$0", "$1", "$2")
    assert tmulticam.multicam_class(["zed", "flir"]).CAMERAS == jmulticam.multicam_class(["zed", "flir"]).CAMERAS

    dispatched = []
    module, posts = _module(cls, dispatched)
    _set_active({"yolo_gate": "forward"})
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 255, hw + (3,), np.uint8) for hw in ((120, 160), (80, 100), (64, 64))]
    decoded, chain_posts = module.detect_chain(*(torch.from_numpy(f) for f in frames), tuners={}, want_posts=True)
    decoded = {k: v.numpy() for k, v in decoded.items()}
    assert all(v.shape[0] == 3 for v in decoded.values())
    assert set(chain_posts) == set(cls.POST_NAMES)
    module.on_device_result(decoded, {k: v.numpy() for k, v in chain_posts.items()}, _meta(("cam0", "cam1", "cam2")))
    for name, frame in zip(cls.POST_NAMES, frames):
        assert posts[name] == frame.shape
    assert len(module._cam_trackers) == 3
    # the gate detector runs on both forward cameras, not on the downward one
    assert [(n, d, s) for n, d, s in dispatched] == [("gate", "forward", frames[0].shape),
                                                     ("gate", "forward", frames[2].shape)]


def test_crosscam_merge_rides_the_dispatch(namespace, monkeypatch):
    monkeypatch.setattr(tmulticam, "CROSSCAM_MERGE", True)
    module, _ = _module(tmulticam.YoloMulticam, [])
    _set_active({})
    rng = np.random.default_rng(2)
    fwd = rng.integers(0, 255, (120, 160, 3), np.uint8)
    flir = rng.integers(0, 255, (80, 100, 3), np.uint8)
    decoded, posts = module.detect_chain(torch.from_numpy(fwd), torch.from_numpy(flir), tuners={}, want_posts=True)
    want = tmulticam._merged_dets(decoded, ((120, 160), (80, 100)), 160)
    assert torch.equal(decoded["crosscam_merged"], want) and want.shape == (32, 6)
    module.on_device_result({k: v.numpy() for k, v in decoded.items()}, {k: v.numpy() for k, v in posts.items()},
                            _meta(("forward", "flir")))
    np.testing.assert_array_equal(module.last_merged, want.numpy())
    assert module.last_merged_count == int((want[:, 4] > 0).sum())


def test_cli_sources_skip_option_values():
    assert tmulticam.cli_sources(["zed", "flir"]) == ["zed", "flir"]
    assert tmulticam.cli_sources(["--device", "cpu", "zed[forward]", "--fps", "1000", "flir",
                                  "--enable-performance"]) == ["zed[forward]", "flir"]
    assert tmulticam.cli_sources(["-f", "5"]) == []
