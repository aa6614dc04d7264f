"""BASELINE config 4's modules on the port (``--device cpu``) against the
JAX package's modules on the same frames and tuners.

* ``preprocessor``: each stage alone and all stages together against the
  JAX module's ``process``: u8 stages exact, the float geometry within the
  JAX package's 1 count per stage; erode/dilate against the JAX module
  with its erode applied per channel (its own windows span W and the
  channels: tests/test_torch_transform.py); the noise stage by mean and
  std only.
* ``color_balance``: ``original`` and ``balanced`` post in pairs, one frame
  late, including across a flag change; each ``balanced`` is the port's
  ``balance`` of its ``original``; and through the real bus from the
  synthetic source.
* ``auto_calibrate`` and ``auto_calibrate_zed`` write the same shm values
  as the JAX modules after the same frames; ``calibrate`` mirrors its
  tuners into shm and posts the JAX module's views.

Each module writes private shm groups, never the shared ones.
"""

import copy
import threading
import time
import types
import uuid

import cv2
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)
from test_torch_private_shm import opened_within

from cuauv_vision_pipeline_tpu.core import shm as jshm
from cuauv_vision_pipeline_tpu.modules import auto_calibrate as jac
from cuauv_vision_pipeline_tpu.modules import auto_calibrate_zed as jacz
from cuauv_vision_pipeline_tpu.modules import calibrate as jcal
from cuauv_vision_pipeline_tpu.modules import preprocessor as jpre
from cuauv_vision_pipeline_tpu.utils import transform as jut
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import Synthetic, buoy_frame
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core.log import log
from cuauv_vision_pipeline_tpu_torch.modules import auto_calibrate as tac
from cuauv_vision_pipeline_tpu_torch.modules import auto_calibrate_zed as tacz
from cuauv_vision_pipeline_tpu_torch.modules import calibrate as tcal
from cuauv_vision_pipeline_tpu_torch.modules import color_balance as tcb
from cuauv_vision_pipeline_tpu_torch.modules import preprocessor as tpre
from cuauv_vision_pipeline_tpu_torch.ops.balance import BalanceConfig, balance


class JaxHarness:
    """A JAX module's ``process``/``handle`` without its runtime: fixed
    tuner values, posts captured."""

    def __init__(self, module_cls, tuners, **state):
        self.posts = {}
        self.values = {t.name: t.value for t in tuners}
        self.module = object.__new__(module_cls)
        self.module.post = lambda name, image, cs="BGR": self.posts.__setitem__(name, (np.array(image), cs))
        values = self.values

        class Tuners:
            def __getitem__(self, k):
                return values[k]

        self.module._module_manager = Tuners()
        for k, v in state.items():
            setattr(self.module, k, v)


class PortModule:
    """The port module built by its own constructor (``--device cpu``, its
    own copies of the tuners), posts captured."""

    def __init__(self, module_cls, tuners, direction="forward", **kwargs):
        self.posts = {}
        self.order = []
        self.module = module_cls([direction], copy.deepcopy(tuners), argv=["--device", "cpu"], **kwargs)

        def post(name, image, cs="BGR"):
            self.posts[name] = (np.array(image), cs)
            self.order.append((name, np.array(image)))

        self.module.post = post

    def set(self, **values):
        for k, v in values.items():
            self.module._module_manager._tuner_sources[k]._current_value = v


def _frame(shape=(64, 96), t=0.3):
    return buoy_frame(shape, t)


# -- preprocessor -------------------------------------------------------------

STAGES = {
    "identity": {},
    "balance": {"balance": True},
    "grayscale": {"grayscale": True},
    "bias": {"bias_r": 40, "bias_g": -30, "bias_b": 200},
    "contrast_brightness": {"contrast": 1.37, "brightness": -20},
    "blur_7": {"blur_kernel": 7},
    "blur_14": {"blur_kernel": 14},
    "rotate": {"rotate_deg": 23.5},
    "resize": {"resize_factor": 0.63},
    "translate": {"translate_x": 7, "translate_y": -4},
}
# float geometry: the JAX package's 1 count per stage
TOLERANCE = {"blur_14": 1, "rotate": 1, "resize": 1, "translate": 1}


def _preprocess_both(values, img, per_channel_jax_morph=False, monkeypatch=None):
    jh = JaxHarness(jpre.Preprocessor, jpre.module_tuners)
    jh.values.update(values)
    if per_channel_jax_morph:
        def per_channel(fn):
            return lambda m, k: np.stack([fn(np.ascontiguousarray(m[..., c]), k) for c in range(3)], -1)

        monkeypatch.setattr(jpre.UT, "erode", per_channel(jut.erode))
        monkeypatch.setattr(jpre.UT, "dilate", per_channel(jut.dilate))
    jh.module.process("forward", img)
    port = PortModule(tpre.Preprocessor, tpre.module_tuners, seed=0)
    port.set(**values)
    port.module.process("forward", img)
    return port.posts["preprocessed"][0], jh.posts["preprocessed"][0]


@pytest.mark.parametrize("stage", list(STAGES))
def test_preprocessor_stage_matches_jax(stage):
    img = _frame()
    got, want = _preprocess_both(STAGES[stage], img)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= TOLERANCE.get(stage, 0)


@pytest.mark.parametrize("split", range(1, 19))
def test_preprocessor_channel_split_matches_jax(split):
    got, want = _preprocess_both({"channel_split": split}, _frame())
    tol = 1 if (split - 1) // 3 == 4 else 0  # LUV: a float path, 1 count
    assert np.abs(got.astype(int) - want.astype(int)).max() <= tol


@pytest.mark.parametrize("op", ["erode_kernel", "dilate_kernel"])
def test_preprocessor_morphology_is_cv2_per_channel(op, monkeypatch):
    img = _frame()
    got, want = _preprocess_both({op: 4}, img, per_channel_jax_morph=True, monkeypatch=monkeypatch)
    fn = cv2.erode if op == "erode_kernel" else cv2.dilate
    np.testing.assert_array_equal(got, fn(img, np.ones((5, 5), np.uint8)))
    np.testing.assert_array_equal(got, want)


def test_preprocessor_all_stages_match_jax(monkeypatch):
    """Every stage but the noise, in the module's order; the float geometry
    (rotate, resize, translate) adds up to a count each."""
    values = {k: v for stage in ("balance", "bias", "contrast_brightness", "blur_7", "rotate", "resize", "translate")
              for k, v in STAGES[stage].items()}
    values.update(channel_split=8, grayscale=True, erode_kernel=2, dilate_kernel=3)  # HLS L channel
    got, want = _preprocess_both(values, _frame(), per_channel_jax_morph=True, monkeypatch=monkeypatch)
    assert got.shape == want.shape == (40, 60, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 3


def test_preprocessor_noise_statistics():
    img = np.full((96, 128, 3), 128, np.uint8)
    port = PortModule(tpre.Preprocessor, tpre.module_tuners, seed=1)
    port.set(noise_stddev=20.0)
    port.module.process("forward", img)
    got = port.posts["preprocessed"][0].astype(np.float64) - 128
    jh = JaxHarness(jpre.Preprocessor, jpre.module_tuners)
    jh.values["noise_stddev"] = 20.0
    jh.module.process("forward", img)
    want = jh.posts["preprocessed"][0].astype(np.float64) - 128
    # 36,864 draws of N(0, 20) added to 128 and truncated to u8 (as JAX
    # does): the mean -0.5 within 0.5 (5 standard errors), the std within
    # 3% of 20
    for d in (got, want):
        assert abs(d.mean() + 0.5) < 0.5 and abs(d.std() / 20.0 - 1) < 0.03
    again = PortModule(tpre.Preprocessor, tpre.module_tuners, seed=1)
    again.set(noise_stddev=20.0)
    again.module.process("forward", img)
    np.testing.assert_array_equal(again.posts["preprocessed"][0], port.posts["preprocessed"][0])


def test_preprocessor_refuses_to_start_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.Preprocessor(["forward"], copy.deepcopy(tpre.module_tuners), argv=[])


# -- color_balance --------------------------------------------------------------


def _pairs(order):
    names = [n for n, _ in order]
    assert names == ["original", "balanced"] * (len(names) // 2), names
    return [(order[i][1], order[i + 1][1]) for i in range(0, len(order), 2)]


def _fetch_threads() -> int:
    """Live StreamExecutor fetch threads (a thread's default name ends with
    its target's)."""
    return sum(t.name.endswith("(_fetch_loop)") for t in threading.enumerate())


# frame index -> the tuner values set before it
FLAG_CHANGES = {
    "switch": {3: dict(rgb_contrast_correct=True, horizontal_blocks=2)},
    "slider": {i: dict(horizontal_blocks=i + 1) for i in range(16)},
}


@pytest.mark.parametrize("change", sorted(FLAG_CHANGES))
def test_color_balance_posts_pairs_across_a_flag_change(change):
    """Each pair posts in frame order, one frame late, and its ``balanced``
    is ``balance`` of its frame under the config of its frame, across one
    switch of two tuners and a slider swept through all 16 block counts;
    the module keeps one executor (one fetch thread) whatever the number of
    settings."""
    threads = _fetch_threads()
    port = PortModule(tcb.ColorBalance, tcb.module_tuners)
    changes = FLAG_CHANGES[change]
    frames = [_frame(t=0.2 * i) for i in range(max(6, len(changes)))]
    configs = []
    for i, f in enumerate(frames):
        port.set(**changes.get(i, {}))
        configs.append(port.module._config())
        port.module.process("forward", f)
    for balanced, original in port.module._executor.flush():
        port.module._post_pair(balanced, original)
    assert _fetch_threads() - threads == 1
    pairs = _pairs(port.order)
    assert len(pairs) == len(frames)
    assert configs[0] == BalanceConfig(**changes.get(0, {}))
    assert all(configs[i]._replace(**values) == configs[i] for i, values in changes.items())
    assert len(set(configs)) == {"switch": 2, "slider": 16}[change]
    for (original, balanced), frame, cfg in zip(pairs, frames, configs):
        np.testing.assert_array_equal(original, frame)
        np.testing.assert_array_equal(balanced, balance(torch.from_numpy(frame), cfg).numpy())


def test_color_balance_through_the_bus(unique_direction):
    source = Synthetic(unique_direction, width=128, height=72, fps=60)
    src_thread = threading.Thread(target=source.run_event_loop)
    src_thread.start()
    time.sleep(0.3)
    posted = []

    class CB(tcb.ColorBalance):
        def post(self, name, image, color_space="BGR"):
            posted.append((name, np.array(image)))

    module = CB([unique_direction], copy.deepcopy(tcb.module_tuners), fps=30, argv=["--device", "cpu"])
    quit_flag = threading.Event()
    try:
        with opened_within(module._module_manager):
            loop = threading.Thread(target=module._loop, args=(quit_flag, log.t))
            loop.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and len(posted) < 6:
                time.sleep(0.05)
            quit_flag.set()
            loop.join(timeout=10)
            assert not loop.is_alive()
    finally:
        source.quit_flag.set()
        src_thread.join(timeout=10)
    pairs = _pairs(posted[: len(posted) // 2 * 2])
    assert len(pairs) >= 3
    for original, balanced in pairs:
        assert original.shape == balanced.shape == (72, 128, 3)
        np.testing.assert_array_equal(balanced, balance(torch.from_numpy(original)).numpy())


# -- calibration modules --------------------------------------------------------


@pytest.fixture
def private_groups(monkeypatch):
    """Point both packages' calibration modules at private groups (the same
    schema under a unique name), one set per package."""
    tag = uuid.uuid4().hex[:10]
    made = []

    def groups(shm_mod, modules, prefix):
        ns = types.SimpleNamespace()
        for g in ("camera_calibration", "zed_calibration"):
            name = f"test_{prefix}_{g}_{tag}"
            setattr(ns, g, shm_mod.define_group(name, shm_mod.DEFAULT_GROUPS[g]))
            made.append((shm_mod, name))
        for m in modules:
            monkeypatch.setattr(m, "shm", ns)
        return ns

    yield groups(jshm, (jac, jacz, jcal), "jax"), groups(tshm, (tac, tacz, tcal), "port")
    for shm_mod, name in made:
        shm_mod.delete_group(name)


def _fields(group):
    g = group.get()
    return {k: getattr(g, k) for k in dir(g) if not k.startswith("_") and not callable(getattr(g, k))}


def _brightness_frames():
    return [np.clip(_frame(t=0.5 * i).astype(int) + off, 0, 255).astype(np.uint8)
            for i, off in enumerate((-90, -60, 0, 40, 90, 120))]


def test_auto_calibrate_writes_what_jax_writes(private_groups):
    jgroups, tgroups = private_groups
    jh = JaxHarness(jac.AutoCalibrate, jac.module_tuners, _exposure_smooth=None)
    port = PortModule(tac.AutoCalibrate, tac.module_tuners)
    for f in _brightness_frames():
        jh.module.process("forward", f)
        port.module.process("forward", f)
        assert _fields(tgroups.camera_calibration) == _fields(jgroups.camera_calibration)
        np.testing.assert_array_equal(port.posts["calibration view"][0], jh.posts["calibration view"][0])
    assert tgroups.camera_calibration.exposure.get() != 50.0


def test_auto_calibrate_zed_writes_what_jax_writes(private_groups):
    jgroups, tgroups = private_groups
    jh = JaxHarness(jacz.AutoCalibrateZed, jacz.module_tuners, _last={})
    port = PortModule(tacz.AutoCalibrateZed, tacz.module_tuners, direction="zed")
    jh.values["exposure_rate"] = 0.9
    port.set(exposure_rate=0.9, contrast=6.5)
    jh.values["contrast"] = 6.5
    for f in _brightness_frames() * 3:  # long enough to spill into the gain
        jh.module.process("zed", f)
        port.module.process("zed", f)
        assert _fields(tgroups.zed_calibration) == _fields(jgroups.zed_calibration)
    assert tgroups.zed_calibration.contrast.get() == 6.5


def test_calibrate_mirrors_tuners_into_shm(private_groups):
    jgroups, tgroups = private_groups
    jh = JaxHarness(jcal.Calibrate, jcal.module_tuners, _last={})
    port = PortModule(tcal.Calibrate, tcal.module_tuners, direction="zed")
    values = {"exposure": 71.5, "red_gain": 1.25, "hue": -12.0, "white_balance": 5100.0}
    jh.values.update(values)
    port.set(**values)
    rng = np.random.default_rng(2)
    forward = _frame()
    depth = rng.uniform(0.0, 12.0, (64, 96, 1)).astype(np.float32)
    normal = rng.uniform(-0.2, 1.2, (64, 96, 3)).astype(np.float32)
    jh.module.handle(forward, depth, normal)
    port.module.handle(forward, depth, normal)
    got = _fields(tgroups.camera_calibration)
    assert got == _fields(jgroups.camera_calibration)
    assert all(got[k] == v for k, v in values.items())
    assert set(port.posts) == set(jh.posts) == {"forward", "depth", "normal"}
    for name in port.posts:
        np.testing.assert_array_equal(port.posts[name][0], jh.posts[name][0])
        assert port.posts[name][1] == jh.posts[name][1]
