"""The port's stereo red_buoy module and one-card fan-out against the JAX
package's, on the CPU, at 120x160.

* ``BuoyStereo.stereo_chain``: both eyes' masks and cleaned masks bit-exact
  (the port's ``fused_morph`` open+close against JAX's composed
  ``close_morph(open_morph(...))``), ``found`` and ``area`` exact,
  ``centroid`` within 1e-3 px (the port sums in int64, JAX in float32);
  among the cases a left eye with the disc and a right eye with none.
* ``on_device_result``: the ``shm.red_buoy_stereo_results`` fields each
  package writes from its own chain's result: visibility and area exact,
  centers within 1e-3, latency not compared (a clock).
* The real port module over the frame bus (``--device cpu``): the left eye
  sees the disc, the right eye none, on a direction and shm namespace of
  this test's own.
* ``fanout.chain_one`` (it labels the CLEANED mask) and ``make_fanout`` on
  N frames, against JAX ``chain_one`` per frame: area and bbox exact,
  centroid within 1e-3.
"""

import threading
import time
import types
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)
from test_torch_private_shm import opened_within

from cuauv_vision_pipeline_tpu.core import shm as jshm
from cuauv_vision_pipeline_tpu.modules import red_buoy_stereo as jstereo
from cuauv_vision_pipeline_tpu.parallel import fanout as jfanout
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.core.base import DeviceResultMeta
from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import BlockAccessor, frame_bytes
from cuauv_vision_pipeline_tpu_torch.core.log import log
from cuauv_vision_pipeline_tpu_torch.modules import red_buoy_stereo as tstereo
from cuauv_vision_pipeline_tpu_torch.parallel import fanout as tfanout

H, W = 120, 160
CENTROID_ATOL = 1e-3  # px: int64 sums on the port, float32 sums in JAX
NO_RED = np.full((H, W, 3), (90, 120, 60), np.uint8)


def _pairs():
    return {
        "disc_both_eyes": (buoy_frame((H, W), 0.0), buoy_frame((H, W), 1.3)),
        "disc_left_none_right": (buoy_frame((H, W), 0.0), NO_RED),
        "none_left_disc_right": (NO_RED, buoy_frame((H, W), 2.1)),
    }


PAIRS = _pairs()
THRESHOLDS = [(140, 255), (0, 255)]


def _tuners(tmin, tmax):
    return {"thresh_min": np.int32(tmin), "thresh_max": np.int32(tmax)}


def _jax_chain(left, right, tmin, tmax):
    fn = jax.jit(lambda a, b: jstereo.BuoyStereo.stereo_chain(
        None, a, b, tuners=_tuners(tmin, tmax), want_posts=True))
    best, posts = fn(jnp.asarray(left), jnp.asarray(right))
    return jax.tree.map(np.asarray, best), jax.tree.map(np.asarray, posts)


def _port_chain(left, right, tmin, tmax):
    best, posts = tstereo.BuoyStereo.stereo_chain(
        None, torch.from_numpy(left), torch.from_numpy(right),
        tuners=_tuners(tmin, tmax), want_posts=True)
    return {k: v.numpy() for k, v in best.items()}, {k: v.numpy() for k, v in posts.items()}


@pytest.mark.parametrize("tmin,tmax", THRESHOLDS)
@pytest.mark.parametrize("case", list(PAIRS))
def test_stereo_chain_matches_jax(case, tmin, tmax):
    left, right = PAIRS[case]
    got, got_posts = _port_chain(left, right, tmin, tmax)
    want, want_posts = _jax_chain(left, right, tmin, tmax)
    assert set(got) == set(want) == {"area", "centroid", "found"}
    assert set(got_posts) == set(want_posts)
    for key in want_posts:
        np.testing.assert_array_equal(got_posts[key], want_posts[key], err_msg=key)
    np.testing.assert_array_equal(got["found"], want["found"])
    np.testing.assert_array_equal(got["area"], want["area"])
    np.testing.assert_allclose(got["centroid"], want["centroid"], rtol=1e-5, atol=CENTROID_ATOL)
    if case == "disc_left_none_right" and tmin == 140:
        assert got["found"].tolist() == [True, False] and got["area"][0] > 20


def test_stereo_chain_without_posts():
    left, right = PAIRS["disc_both_eyes"]
    best, posts = tstereo.BuoyStereo.stereo_chain(
        None, torch.from_numpy(left), torch.from_numpy(right),
        tuners=_tuners(140, 255), want_posts=False)
    assert posts == {} and best["found"].shape == (2,) and best["centroid"].shape == (2, 2)


@pytest.fixture
def result_groups(monkeypatch):
    """Each package's module pointed at a results group of this test's own."""
    name = f"test_stereo_{uuid.uuid4().hex[:12]}"
    tgroup = tshm.define_group(name, tstereo.RESULTS_SCHEMA)
    jgroup = jshm.define_group(f"{name}_jax", tstereo.RESULTS_SCHEMA)
    monkeypatch.setattr(tstereo, "shm", types.SimpleNamespace(red_buoy_stereo_results=tgroup))
    monkeypatch.setattr(jstereo, "shm", types.SimpleNamespace(red_buoy_stereo_results=jgroup))
    yield tgroup, jgroup
    tshm.delete_group(name)
    jshm.delete_group(f"{name}_jax")


def _module(cls, posted):
    module = object.__new__(cls)
    module.normalize = lambda c: (c[0] / W - 0.5 * H / W, c[1] / W - 0.5)
    module.post = lambda name, img, cs="BGR": posted.append((name, img.shape, cs))
    return module


@pytest.mark.parametrize("case", list(PAIRS))
def test_on_device_result_fields_match_jax(case, result_groups):
    tgroup, jgroup = result_groups
    left, right = PAIRS[case]
    meta = DeviceResultMeta(aliases=("forward", "forward2"),
                            acquisition_time=int(time.monotonic() * 1000), submit_time=time.monotonic())
    tposted, jposted = [], []
    _module(tstereo.BuoyStereo, tposted).on_device_result(*_port_chain(left, right, 140, 255), meta)
    _module(jstereo.BuoyStereo, jposted).on_device_result(*_jax_chain(left, right, 140, 255), meta)
    got, want = tgroup.get(), jgroup.get()
    for side in ("left", "right"):
        assert getattr(got, f"visible_{side}") == getattr(want, f"visible_{side}")
        assert getattr(got, f"area_{side}") == getattr(want, f"area_{side}")
        for axis in ("x", "y"):
            key = f"center_{axis}_{side}"
            assert getattr(got, key) == pytest.approx(getattr(want, key), abs=CENTROID_ATOL)
    assert got.latency_ms >= 0
    assert sorted(tposted) == sorted(jposted)
    assert len(tposted) == 4 and all(cs == "GRAY" for _, _, cs in tposted)


@pytest.fixture
def namespace(monkeypatch):
    """A shm namespace of this test's own, holding the stereo group."""
    monkeypatch.setenv(tshm.NAMESPACE_ENV, f"test-{uuid.uuid4().hex[:10]}")
    tshm.define_group("red_buoy_stereo_results", tstereo.RESULTS_SCHEMA)
    yield
    for name in ("red_buoy_stereo_results",):
        tshm.delete_group(name)


def test_stereo_module_over_the_bus(unique_direction, namespace):
    """Both eyes through one batched dispatch of the unmodified module: the
    left eye detects the disc and the right eye, with no red, nothing."""
    tuners = [type(t)(t.name, 140 if t.name == "thresh_min" else 255, 0, 255)
              for t in tstereo.module_tuners]
    module = tstereo.BuoyStereo([unique_direction], tuners, fps=30, argv=["--device", "cpu"])
    left = buoy_frame((H, W), 0.0)
    size = frame_bytes(((H, W, 3), np.uint8), ((H, W, 3), np.uint8))
    quit_flag = threading.Event()
    results = tshm.red_buoy_stereo_results
    with BlockAccessor(unique_direction, size) as writer:
        with opened_within(module._module_manager):
            loop = threading.Thread(target=module._loop, args=(quit_flag, log.t))
            loop.start()
            try:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    writer.write_frame(int(time.monotonic() * 1000), [("forward", left), ("forward2", NO_RED)])
                    if results.visible_left.get():
                        break
                    time.sleep(0.05)
            finally:
                quit_flag.set()
                loop.join(timeout=30)
    assert not loop.is_alive()
    res = results.get()
    assert res.visible_left, "left eye never detected the disc"
    assert not res.visible_right, "right eye false-positived"
    want, _ = _port_chain(left, NO_RED, 140, 255)
    assert res.area_left == want["area"][0] > 20
    assert abs(res.center_x_left) < 0.6 and abs(res.center_y_left) < 0.6


def _jax_chain_one(frame, tmin, tmax):
    out = jax.jit(jfanout.chain_one)(jnp.asarray(frame), jnp.int32(tmin), jnp.int32(tmax))
    return {k: np.asarray(v) for k, v in out.items()}


def _check_blob(got, want):
    assert set(got) == set(want) == {"area", "centroid", "bbox"}
    np.testing.assert_array_equal(got["area"], want["area"])
    np.testing.assert_array_equal(got["bbox"], want["bbox"])
    np.testing.assert_allclose(got["centroid"], want["centroid"], rtol=1e-5, atol=CENTROID_ATOL)


@pytest.mark.parametrize("tmin,tmax", THRESHOLDS)
@pytest.mark.parametrize("t", [0.0, 1.3, 2.1])
def test_chain_one_matches_jax(t, tmin, tmax):
    frame = buoy_frame((H, W), t)
    got = {k: v.numpy() for k, v in tfanout.chain_one(torch.from_numpy(frame), tmin, tmax).items()}
    _check_blob(got, _jax_chain_one(frame, tmin, tmax))


def test_chain_one_labels_the_cleaned_mask():
    """A lone 2x2 red speck: open removes it, so chain_one (cleaned mask)
    finds nothing where red_buoy_fused (un-cleaned mask) finds 4 pixels."""
    from cuauv_vision_pipeline_tpu_torch.engine.chains import red_buoy_fused

    frame = NO_RED.copy()
    frame[50:52, 70:72] = (30, 30, 220)
    got = tfanout.chain_one(torch.from_numpy(frame), 140, 255)
    assert int(got["area"]) == 0
    assert int(red_buoy_fused(torch.from_numpy(frame), 140, 255)[2]["area"]) == 4
    _check_blob({k: v.numpy() for k, v in got.items()}, _jax_chain_one(frame, 140, 255))


def test_make_fanout_matches_jax_per_camera():
    frames = np.stack([buoy_frame((H, W), 0.9 * cam) for cam in range(4)] + [NO_RED])
    fan = tfanout.make_fanout("cpu")
    got = {k: v.numpy() for k, v in fan(frames, 140, 255).items()}
    assert got["area"].shape == (5,) and got["centroid"].shape == (5, 2) and got["bbox"].shape == (5, 4)
    for cam, frame in enumerate(frames):
        _check_blob({k: v[cam] for k, v in got.items()}, _jax_chain_one(frame, 140, 255))
    assert (got["area"][:4] > 20).all() and got["area"][4] == 0


def test_make_fanout_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfanout.make_fanout()
