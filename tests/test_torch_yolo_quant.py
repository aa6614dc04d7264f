"""The port's quantized YOLO modes (``models/yolo/quant.py``) against the JAX
package's ``quantize_weights_int8`` and ``_w8a8_conv_interceptor``, on the
same parameters and numpy inputs, on the CPU at size ``p``.

Tolerances: the int8 store (values and per-channel scales) exactly equal to
JAX's, the ConvTranspose's included; the plain int8 convolution exactly
equal to ``lax.conv_general_dilated(..., preferred_element_type=int32)``,
and the card's im2col + ``_int_mm`` layout exactly equal to the plain one
(``_int_mm`` runs on the CPU too); weight-only int8 head maps (float32)
within rtol = atol = 1e-4 of JAX's, unfused and folded; one w8a8 conv on
the same float32 input (a Conv-BN-SiLU conv at stride 2 and 1, a head's
output conv): the int8 activations, int8 weights and int32 accumulators
exactly equal to the interceptor's, the rescaled output within one float32
ulp; w8a8 head maps (float32) within 3% of each map's largest magnitude of
JAX's: the two libraries' SiLU and BatchNorm round an ulp apart, and where
that moves an activation across a rounding edge of its int8 grid, one
quantization step spreads through the later layers.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo.model import create_model as jcreate
from cuauv_vision_pipeline_tpu.models.yolo.predictor import _w8a8_conv_interceptor, quantize_weights_int8
from cuauv_vision_pipeline_tpu_torch.models.yolo import quant
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import YOLO, ConvBnSilu, PlainConv
from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import match_detections, render_scene
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import (
    _module_pairs,
    _tensor_entries,
    _to_torch_layout,
    params_from_flax,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
NC = 4
TASKS = ("obb", "pose", "segment", "classify")


def redraw(tree, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        if x.ndim >= 2:
            return rng.normal(0, 1 / np.sqrt(np.prod(x.shape[:-1])), x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def flax_models():
    out = {}
    for task in TASKS:
        model, variables = jcreate(NC, size="p", task=task, image_size=64)
        out[task] = (model, redraw(variables, seed=len(out)))
    return out


def _node(tree, path):
    for part in path:
        tree = tree[part]
    return np.asarray(tree)


@pytest.mark.parametrize("task", TASKS)
def test_int8_store_equals_jax(flax_models, task):
    _, variables = flax_models[task]
    jq, js = quantize_weights_int8(variables)
    model = YOLO(NC, "p", task)
    model.load_state_dict(params_from_flax(variables, task))
    store = quant.quantize_weights_int8(model)
    n = 0
    for tp, fp, kind in _module_pairs(variables["params"], task):
        for tkey, fkey, layout in _tensor_entries(tp, fp, kind):
            if layout not in ("conv", "convT"):
                assert tkey not in store, tkey  # BatchNorm, biases, the Dense kernel stay float
                continue
            q, s = store[tkey]
            want_q = _to_torch_layout(_node(jq, fkey), layout)
            assert q.dtype == torch.int8 and want_q.dtype == np.int8
            np.testing.assert_array_equal(q.numpy(), want_q, err_msg=tkey)
            np.testing.assert_array_equal(s.numpy(), _node(js, fkey).reshape(-1), err_msg=tkey)
            n += 1
    assert n == len(store) > 20
    if task == "segment":
        assert store["model.22.proto.upsample.weight"][1].shape == (32,)  # per output channel (dim 1)


CONVS = [(3, 1), (3, 2), (1, 1), (1, 2)]


@pytest.mark.parametrize("kernel,stride", CONVS, ids=[f"{k}x{k}_s{s}" for k, s in CONVS])
def test_int8_conv_plain_equals_lax(kernel, stride):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.integers(-127, 128, (2, 9, 11, 16), dtype=np.int8)  # NHWC
    w = rng.integers(-127, 128, (kernel, kernel, 16, 24), dtype=np.int8)  # HWIO
    pad = kernel // 2
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), [(pad, pad)] * 2,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
    got = quant.int8_conv_plain(torch.from_numpy(x).permute(0, 3, 1, 2),
                                torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


# (C_in, C_out, kernel, stride, H, W): layer 0 (K = 27), the angle head
# (N = 1), class heads (N = 2, 15, 80), a map of fewer than 17 pixels
GEMM_SHAPES = [(3, 16, 3, 2, 20, 24), (16, 1, 1, 1, 6, 5), (8, 2, 1, 1, 5, 7), (32, 15, 1, 1, 4, 4),
               (64, 80, 1, 1, 3, 3), (40, 24, 3, 1, 5, 6)]


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=[f"c{s[0]}_o{s[1]}_k{s[2]}_s{s[3]}" for s in GEMM_SHAPES])
def test_int8_gemm_conv_equals_plain(shape):
    c, o, k, s, h, w = shape
    conv = torch.nn.Conv2d(c, o, k, s, k // 2)
    qc = quant.Int8Conv(conv, torch.float32)
    assert qc.wmat.shape[0] % 8 == 0 and qc.wmat.shape[1] % 8 == 0
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-127, 128, (1, c, h, w), generator=g).to(torch.int8)
    x = x.contiguous(memory_format=torch.channels_last)
    got = quant.int8_gemm_conv(x, qc.wmat, k, s, k // 2, o)
    assert torch.equal(got, quant.int8_conv_plain(x, qc.wq, s, k // 2))


def _maps(out):
    for key, value in out.items():
        for i, v in enumerate(value if isinstance(value, (list, tuple)) else [value]):
            yield f"{key}[{i}]", np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "folded"])
@pytest.mark.parametrize("task", TASKS)
def test_int8_head_maps_match_jax(flax_models, task, fused):
    jmodel, variables = flax_models[task]
    jq, js = quantize_weights_int8(variables)
    deq = jax.tree.map(lambda q, s: q.astype(np.float32) * s if q.dtype == np.int8 else q, jq, js)
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    want = dict(_maps(jax.jit(jmodel.apply)(deq, jnp.asarray(x))))
    model = YOLO(NC, "p", task).eval()
    model.load_state_dict(params_from_flax(variables, task))
    quant.dequantize_int8_(model, quant.quantize_weights_int8(model), torch.float32)
    if fused:
        model.fuse_(torch.float32)
    with torch.no_grad():
        got = dict(_maps(model(torch.from_numpy(x).permute(0, 3, 1, 2))))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("task", TASKS)
def test_w8a8_head_maps_match_jax(flax_models, task):
    jmodel, variables = flax_models[task]
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    with nn.intercept_methods(_w8a8_conv_interceptor):
        want = dict(_maps(jmodel.apply(variables, jnp.asarray(x))))
    model = YOLO(NC, "p", task).eval()
    model.load_state_dict(params_from_flax(variables, task))
    quant.w8a8_(model, torch.float32)
    calls = []
    real = quant.int8_conv
    quant.int8_conv = lambda xq, conv: calls.append(conv) or real(xq, conv)
    try:
        with torch.no_grad():
            got = dict(_maps(model(torch.from_numpy(x).permute(0, 3, 1, 2))))
    finally:
        quant.int8_conv = real
    # every conv ran as int8 (ConvBnSilu, head outputs); ConvTranspose and Linear did not
    n_conv = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert len(calls) == n_conv and len({id(c) for c in calls}) == n_conv
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=0.03 * np.abs(w).max(), err_msg=name)


# (name, port conv, the flax conv JAX's model builds for it, input channels)
ONE_CONV = [
    ("conv_bn_silu_3x3_s2", lambda: ConvBnSilu(16, 24, 3, 2).conv,
     lambda: nn.Conv(24, (3, 3), strides=2, padding=1, use_bias=False), 16),
    ("conv_bn_silu_3x3_s1", lambda: ConvBnSilu(24, 16, 3, 1).conv,
     lambda: nn.Conv(16, (3, 3), strides=1, padding=1, use_bias=False), 24),
    ("head_out_1x1", lambda: PlainConv(32, 15, 1), lambda: nn.Conv(15, (1, 1)), 32),
]


@pytest.mark.parametrize("case", ONE_CONV, ids=[c[0] for c in ONE_CONV])
def test_w8a8_one_conv_equals_jax(monkeypatch, case):
    """One conv under JAX's interceptor and through ``Int8Conv``: the same
    activation quantization (one scale per tensor, half to even: the input
    holds exact ties), the same int8 weights, the same int32 accumulators,
    and the rescale and bias in the same order."""
    _, make_port, make_flax, c_in = case
    x = np.random.default_rng(3).normal(0, 20, (2, 12, 10, c_in)).astype(np.float32)
    x[0, 0, 0, 0] = 127.0  # the scale is then exactly 1
    x[1, :2, :3, :4] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32).repeat(4)[:24].reshape(2, 3, 4)
    fconv = make_flax()
    variables = redraw(fconv.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=4)
    seen = {}
    real = jax.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        out = real(lhs, rhs, *args, **kwargs)
        seen.update(x_q=np.asarray(lhs), k_q=np.asarray(rhs), acc=np.asarray(out))
        return out

    monkeypatch.setattr(jax.lax, "conv_general_dilated", spy)
    with nn.intercept_methods(_w8a8_conv_interceptor):
        want = np.asarray(fconv.apply(variables, jnp.asarray(x)))
    assert seen["acc"].dtype == np.int32

    conv = make_port()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
        if conv.bias is not None:
            conv.bias.copy_(torch.from_numpy(np.asarray(variables["params"]["bias"])))
    qconv = quant.Int8Conv(conv, torch.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    xq, s_x = quant.quantize_activation(xt)
    assert s_x.item() == 1.0
    np.testing.assert_array_equal(xq.permute(0, 2, 3, 1).numpy(), seen["x_q"])
    np.testing.assert_array_equal(qconv.wq.permute(2, 3, 1, 0).numpy(), seen["k_q"])
    np.testing.assert_array_equal(quant.int8_conv(xq, qconv).permute(0, 2, 3, 1).numpy(), seen["acc"])
    got = qconv(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_modes_from_arguments_and_environment(monkeypatch):
    for var in ("CUAUV_YOLO_QUANT", "CUAUV_YOLO_INT8"):
        monkeypatch.delenv(var, raising=False)
    assert quant.resolve_mode(None) is None
    assert quant.resolve_mode("w8a8") == "w8a8"
    monkeypatch.setenv("CUAUV_YOLO_INT8", "1")
    assert quant.resolve_mode(None) == "int8"
    monkeypatch.setenv("CUAUV_YOLO_QUANT", "w8a8")  # the named mode wins
    assert quant.resolve_mode(None) == "w8a8"
    assert quant.resolve_mode("int8") == "int8"
    with pytest.raises(ValueError, match="unsupported quantize mode 'int4'"):
        quant.resolve_mode("int4")


def test_quantized_fixture_within_the_budget():
    """The trained detect fixture served int8 and w8a8 (bf16 activations)
    keeps recall and precision within 0.1 of the bf16 mode on 8 scenes
    (the JAX package's budget); ``to()`` twice serves the same."""
    kw = dict(image_size=128, max_det=8, conf_thresh=0.25, device="cpu")
    rng = np.random.default_rng(77)
    scenes = [render_scene(rng, size=128, max_objects=3) for _ in range(8)]
    scores = {}
    for mode in (None, "int8", "w8a8"):
        model = YoloModel(os.path.join(FIXTURES, "synth_pico_detect.msgpack"), quantize=mode, **kw)
        assert model.quantize == mode
        first = model.device_decode(scenes[0][0])
        model.to("cpu")
        again = model.device_decode(scenes[0][0])
        assert all(torch.equal(first[k], again[k]) for k in first)
        tp = n_gt = n_pred = 0
        for img, boxes, cls in scenes:
            decoded = {k: v.float().numpy() if v.is_floating_point() else v.numpy()
                       for k, v in model.device_decode(img).items()}
            t, g, p = match_detections(decoded, boxes, cls)
            tp, n_gt, n_pred = tp + t, n_gt + g, n_pred + p
        scores[mode] = (tp / n_gt, tp / max(n_pred, 1))
    assert scores[None][0] >= 0.75
    for mode in ("int8", "w8a8"):
        assert scores[mode][0] >= scores[None][0] - 0.1, scores
        assert scores[mode][1] >= scores[None][1] - 0.1, scores
