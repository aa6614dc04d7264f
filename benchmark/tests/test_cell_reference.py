"""The plain references on the CPU: against OpenCV where it is installed,
and against the port's own CPU path on small frames."""

import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
import scenes  # noqa: E402

RB = harness.load_file(BENCH / "configs" / "red_buoy_1080p_ref.py")
RB_CFG = harness.load_json(BENCH / "configs" / "red_buoy_1080p.json")
SCENE = harness.load_json(BENCH / "traffic" / "stream.json")["scene"]


def test_lab_a_equals_opencv_on_every_colour():
    cv2 = pytest.importorskip("cv2")
    v = np.arange(256, dtype=np.uint8)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    img = np.stack([b, g, r], -1).reshape(4096, 4096, 3)
    a = RB.lab_a(torch.from_numpy(img)).numpy()
    assert np.array_equal(a, cv2.cvtColor(img, cv2.COLOR_BGR2Lab)[..., 1])


def _port_best(frames: torch.Tensor):
    from cuauv_vision_pipeline_tpu_torch.engine.chains import red_buoy_fused

    _, _, best = red_buoy_fused(frames, RB_CFG["tuners"]["thresh_min"], RB_CFG["tuners"]["thresh_max"],
                                RB_CFG["max_components"])
    return {k: v.numpy() for k, v in best.items()}


@pytest.mark.parametrize("kind", ["scenes", "noise"])
def test_red_buoy_reference_equals_the_port_on_the_cpu(kind):
    if kind == "scenes":
        frames = scenes.make_scenes(6, 90, 150, SCENE, 4, torch.device("cpu"))
    else:  # dense red noise: many components, the K-first-roots rule decides
        g = torch.Generator().manual_seed(5)
        frames = torch.randint(0, 256, (3, 40, 64, 3), generator=g, dtype=torch.uint8)
    want = RB.largest_blob(frames, RB_CFG["tuners"]["thresh_min"], RB_CFG["tuners"]["thresh_max"],
                           RB_CFG["max_components"])
    got = _port_best(frames)
    assert want["found"].any()
    assert np.array_equal(got["found"], want["found"])
    assert np.array_equal(got["area"], want["area"])
    assert np.array_equal(got["bbox"], want["bbox"])
    found = want["found"]
    assert np.array_equal(got["centroid"][found], want["centroid"][found])


def test_the_control_centroid_is_bfloat16():
    frames = scenes.make_scenes(4, 90, 150, SCENE, 4, torch.device("cpu"))
    args = (RB_CFG["tuners"]["thresh_min"], RB_CFG["tuners"]["thresh_max"], RB_CFG["max_components"])
    want, ctl = RB.largest_blob(frames, *args), RB.control(frames, *args)
    assert np.array_equal(want["area"], ctl["area"])
    gap = np.abs(want["centroid"] - ctl["centroid"])[want["found"]].max()
    assert 0 < gap < 2.0

