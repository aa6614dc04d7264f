"""The port's YOLO network against the JAX package's flax model, on the same
parameters (carried over by ``params_from_flax``) and the same numpy inputs.

Raw head outputs (``box``, ``cls``, ``angle`` per scale, NHWC) at float32
agree within rtol = atol = 1e-4, with the BatchNorms as modules and folded
into the convs (``fuse_``). Cases: seeded flax init (detect and obb), the
trained detect fixture, and an obb tree whose every leaf was redrawn from a
seeded numpy generator (init's activations are tiny; these are not). JAX
models are built at image_size 64 (parameters do not depend on it).

``preprocess_fused`` equals the JAX package's at the u8 level for the ZED,
720p, VGA and square frames."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo.model import YOLO as JYOLO
from cuauv_vision_pipeline_tpu.models.yolo.model import create_model as jcreate
from cuauv_vision_pipeline_tpu.models.yolo.model import preprocess_fused as jpreprocess
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import YOLO, preprocess_fused
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import msgpack_restore, params_from_flax

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "synth_pico_detect.msgpack")


@pytest.fixture(scope="module")
def flax_models():
    """name -> (flax module, variables, task, num_classes)."""
    out = {}
    for task in ("detect", "obb"):
        model, variables = jcreate(4, size="p", task=task, image_size=64)
        out[f"init_{task}"] = (model, jax.tree.map(np.asarray, variables), task, 4)
    rng = np.random.default_rng(0)

    def redraw(leaf):
        if leaf.ndim == 4:  # HWIO kernels: unit output variance
            return rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:3])), leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    model, variables, _, _ = out["init_obb"]
    out["redrawn_obb"] = (model, jax.tree.map(redraw, variables), "obb", 4)
    with open(FIXTURE, "rb") as fh:
        out["trained_detect"] = (JYOLO(num_classes=2, size="p", task="detect"),
                                 msgpack_restore(fh.read()), "detect", 2)
    return out


_JAX_OUT = {}


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "folded"])
@pytest.mark.parametrize("case", ["init_detect", "init_obb", "trained_detect", "redrawn_obb"])
def test_head_outputs_match_jax(flax_models, case, fused):
    jmodel, variables, task, nc = flax_models[case]
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    if case not in _JAX_OUT:  # the same for both parametrisations of fused
        _JAX_OUT[case] = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    want = _JAX_OUT[case]
    model = YOLO(nc, "p", task).eval()
    model.load_state_dict(params_from_flax(variables, task))
    if fused:
        model.fuse_(torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(got) == set(want) == ({"box", "cls", "angle"} if task == "obb" else {"box", "cls"})
    for key in want:
        for scale, (g, w) in enumerate(zip(got[key], want[key])):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=f"{key}[{scale}]")
    if case == "trained_detect":  # real logits, not init's near-zero ones
        assert np.abs(np.asarray(want["cls"][0])).max() > 1.0


@pytest.mark.parametrize("hw", [(1080, 1920), (720, 1280), (480, 640), (640, 640)])
def test_preprocess_fused_matches_jax_at_u8(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = np.asarray(jpreprocess(jnp.asarray(img)[None], 640))
    got = preprocess_fused(torch.from_numpy(img)[None], 640).numpy()
    assert got.shape == want.shape == (1, 640, 640, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(np.rint(got * 255), np.rint(want * 255))
