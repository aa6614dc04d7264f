"""The port's red_buoy chain, batched lane, result packing and stream
executor on the CPU, against the JAX chain where one exists."""

import time

import jax
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu.engine import chains as jchains
from cuauv_vision_pipeline_tpu_torch.engine import chains as tchains
from cuauv_vision_pipeline_tpu_torch.engine.executor import (
    DevicePipeline,
    StreamExecutor,
    build_packed_fn,
    pack_result,
    unpack_result,
)

SHAPE = (144, 256)
CPU = torch.device("cpu")


def assert_best_equal(got, want):
    for key in ("found", "area", "bbox"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    # float32 sums are taken in another order
    np.testing.assert_allclose(
        np.asarray(got["centroid"]), np.asarray(want["centroid"]), rtol=1e-5, atol=1e-3
    )


@pytest.mark.parametrize("batched", [0, 1])
def test_red_buoy_fused_matches_jax(batched):
    """One [H, W, 3] frame, or (batched) a [2, H, W, 3] batch whose lane b
    equals the JAX chain on frame b."""
    jfused = jax.jit(lambda img, lo, hi: jchains.red_buoy_fused(img, lo, hi))
    frames = [buoy_frame(SHAPE, 0.3 + t) for t in range(1 + batched)]
    batch = np.stack(frames) if batched else frames[0]
    for tmin, tmax in [(0, 255), (140, 255), (150, 200)]:
        tt, tc, tbest = tchains.red_buoy_fused(
            torch.from_numpy(batch), np.int32(tmin), np.int32(tmax)
        )
        for b, frame in enumerate(frames):
            lane = (lambda x: x[b]) if batched else (lambda x: x)
            jt, jc, jbest = jfused(frame, np.int32(tmin), np.int32(tmax))
            np.testing.assert_array_equal(lane(tt).numpy(), np.asarray(jt))
            np.testing.assert_array_equal(lane(tc).numpy(), np.asarray(jc))
            best = {k: lane(v).numpy() for k, v in tbest.items()}
            assert_best_equal(best, jbest)
    assert bool(best["found"]) and int(best["area"]) < SHAPE[0] * SHAPE[1]


def test_red_buoy_chain_matches_fused():
    frame = torch.from_numpy(buoy_frame(SHAPE, 1.1))
    a = tchains.red_buoy_chain(frame, 140, 255)
    b = tchains.red_buoy_fused(frame, 140, 255)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for key in b[2]:
        assert torch.equal(a[2][key], b[2][key]), key


def test_batched_lane_equals_per_frame_and_jax():
    frames = np.stack([buoy_frame(SHAPE, t) for t in (0.0, 2.0)])
    pipe = tchains.RedBuoyPipeline(device="cpu")
    batched = pipe.run_async_batched(frames, 140, 255)
    jbatched = jchains.RedBuoyPipeline().run_async_batched(
        frames, np.int32(140), np.int32(255)
    )
    for b in range(frames.shape[0]):
        one = pipe.run_async(frames[b], 140, 255)
        assert torch.equal(batched[0][b], one[0])
        assert torch.equal(batched[1][b], one[1])
        for key in one[2]:
            assert torch.equal(batched[2][key][b], one[2][key]), key
        np.testing.assert_array_equal(batched[0][b].numpy(), np.asarray(jbatched[0][b]))
        np.testing.assert_array_equal(batched[1][b].numpy(), np.asarray(jbatched[1][b]))
        assert_best_equal(
            {k: v[b].numpy() for k, v in batched[2].items()},
            {k: np.asarray(v[b]) for k, v in jbatched[2].items()},
        )


def test_pipeline_refuses_cuda_when_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchains.RedBuoyPipeline()


def test_pack_unpack_round_trip():
    rng = np.random.default_rng(0)
    tree = (
        {
            "u8": torch.from_numpy(rng.integers(0, 256, (3, 5, 7), dtype=np.uint8)),
            "flag": torch.tensor(True),
            "mask": torch.from_numpy(rng.random(11) < 0.5),
            "i32": torch.tensor([-(2**31), 7, 2**31 - 1], dtype=torch.int32),
        },
        {
            "f32": torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32)),
            "f64": torch.tensor(np.pi, dtype=torch.float64),
            "odd": torch.zeros(0, dtype=torch.float64),
        },
    )
    packed, spec = pack_result(tree)
    assert packed.dtype == torch.uint8 and packed.ndim == 1
    back = unpack_result(packed.numpy(), spec)
    assert isinstance(back, tuple) and list(back[0]) == list(tree[0])
    for got, want in zip(
        list(back[0].values()) + list(back[1].values()),
        list(tree[0].values()) + list(tree[1].values()),
    ):
        want = want.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_packed_fn_map_mode_stacks_lanes():
    def chain(frame, *, tuners, want_posts):
        best = {"sum": frame.sum(dtype=torch.int64), "max": frame.amax()}
        return best, ({"frame": frame} if want_posts else {})

    fn = build_packed_fn(chain, 4, "map")
    frames = torch.arange(2 * 3 * 4, dtype=torch.uint8).reshape(2, 3, 4)
    result, posts = unpack_result(*_to_host(fn(frames, tuners={}, want_posts=True)))
    np.testing.assert_array_equal(result["sum"], frames.sum(dim=(1, 2)).numpy())
    np.testing.assert_array_equal(posts["frame"], frames.numpy())


def _to_host(packed_and_spec):
    packed, spec = packed_and_spec
    return packed.numpy(), spec


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("async_fetch", [False, True])
def test_stream_executor_in_order(depth, async_fetch):
    def fn(x, *, k):
        time.sleep(0.002 * (int(x[0]) % 3))  # uneven per-frame cost
        return {"y": x * k}

    ex = StreamExecutor(DevicePipeline(fn, CPU), depth=depth, async_fetch=async_fetch)
    out = []
    try:
        for i in range(10):
            ready = ex.submit((np.full(4, i, np.int64),), meta=i, k=3)
            assert ex.pending <= depth + 1
            out.extend(ready)
        out.extend(ex.flush(timeout_s=10))
    finally:
        ex.close()
    assert [meta for _, meta in out] == list(range(10))
    for result, meta in out:
        np.testing.assert_array_equal(result["y"], np.full(4, 3 * meta))
    assert ex.pending == 0
