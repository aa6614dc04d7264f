"""The ZED source's postprocess (``capture_sources/zed.py:_postprocess_fn``)
on the card against the same function on the CPU, bit for bit: the ZED SDK
double's HD720 frames (``tests/fake_sdk/pyzed/sl.py``: depth and normals
with NaN and +-inf holes) and seeded odd-sized arrays.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_capture_cuda.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.capture_sources.zed import _postprocess_fn

pytestmark = pytest.mark.cuda

FAKE_SL = Path(__file__).resolve().parent / "fake_sdk" / "pyzed" / "sl.py"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _postprocess_fn("cuda:0")


def _fake_sl():
    spec = importlib.util.spec_from_file_location("fake_pyzed_sl", FAKE_SL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _check(card, inputs):
    got, want = card(*inputs), _postprocess_fn("cpu")(*inputs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.ascontiguousarray(g).view(np.uint8), np.ascontiguousarray(w).view(np.uint8))
    return got


@pytest.mark.parametrize("k", range(4))
def test_postprocess_card_equals_cpu_on_the_sdk_double(card, k):
    sl = _fake_sl()
    left, right, depth, normals = _check(card, sl.frame(k))
    assert left.shape == (sl.HEIGHT, sl.WIDTH, 3) and depth.shape == (sl.HEIGHT, sl.WIDTH, 1)
    assert np.isfinite(depth).all() and np.isfinite(normals).all()


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (481, 641)])
def test_postprocess_card_equals_cpu_at_odd_sizes(card, shape):
    rng = np.random.default_rng(sum(shape))
    depth = rng.uniform(-1e30, 1e30, shape).astype(np.float32)
    normals = rng.uniform(-1.0, 1.0, shape + (4,)).astype(np.float32)
    for plane in (depth, normals[..., :3]):
        holes = rng.random(plane.shape)
        plane[holes < 0.1] = np.nan
        plane[(holes >= 0.1) & (holes < 0.2)] = np.inf
        plane[(holes >= 0.2) & (holes < 0.3)] = -np.inf
    eyes = [rng.integers(0, 256, shape + (4,), dtype=np.uint8) for _ in range(2)]
    _check(card, (*eyes, depth, normals))
