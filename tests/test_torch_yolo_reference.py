"""The benchmark's plain reference of YOLOv8n-OBB
(``benchmark/configs/yolov8n_obb_640_ref.py``, loaded by its path) against
the port on the CPU, both in float32, on seeded random weights whose
BatchNorms are set from the frames (so the maps are of unit scale), at the
pico and n widths: head maps, the letterboxed u8 input, decode, the greedy
NMS, and the count of operations."""

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.models.yolo.decode import _top_pool, candidates, select
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import BatchNorm, create_model, preprocess_fused
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import export_ultralytics_state

REPO = Path(__file__).resolve().parents[1]
REF_PATH = REPO / "benchmark" / "configs" / "yolov8n_obb_640_ref.py"
SIZE = 160
ULPS = 4  # decode: the two orders of the same float32 operations


def _load_reference():
    spec = importlib.util.spec_from_file_location("yolov8n_obb_640_ref", REF_PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load_reference()


def _frames(n=2, h=240, w=320, seed=3):
    """Noisy teal frames with a few bright blocks."""
    g = torch.Generator().manual_seed(seed)
    frames = (torch.randint(80, 140, (n, h, w, 3), generator=g)).to(torch.uint8)
    for i in range(n):
        for _ in range(3):
            y, x = (int(v) for v in torch.randint(0, min(h, w) - 40, (2,), generator=g))
            frames[i, y:y + 40, x:x + 40] = torch.randint(0, 256, (3,), generator=g).to(torch.uint8)
    return frames


def _model(size, letterboxed, seed=5):
    """A random-init OBB model whose BatchNorms take scale 0.3 and the
    statistics of their inputs on ``letterboxed``, and whose head output
    convs get random biases (the class logits' around -1.5, so that some
    anchors fall below ``conf``)."""
    model = create_model(15, size, "obb", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)

    def take(mod, args):
        mod.running_mean.copy_(args[0].mean((0, 2, 3)))
        mod.running_var.copy_(args[0].var((0, 2, 3), unbiased=False))

    hooks = []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.weight.data.fill_(0.3)
            m.bias.data.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
            hooks.append(m.register_forward_pre_hook(take))
    with torch.no_grad():
        model(letterboxed.permute(0, 3, 1, 2).float() / 255.0)
        head = model.model["22"]
        for branch in list(head.cv2) + list(head.cv3) + list(head.cv4):
            branch[2].bias.copy_(0.3 * torch.randn(branch[2].bias.shape, generator=g))
        for branch in head.cv3:
            branch[2].bias.sub_(1.5)
    for h in hooks:
        h.remove()
    return model


@pytest.fixture(scope="module")
def cases():
    frames = _frames()
    lb = REF.letterbox(frames, SIZE)
    return {size: (frames, lb, _model(size, lb)) for size in ("p", "n")}


def _port_maps(model, lb):
    with torch.no_grad():
        return model(lb.permute(0, 3, 1, 2).float() / 255.0)


def _as_reference_maps(out):
    """The port's NHWC per-key lists as the reference's per-stride NCHW
    (box, cls, angle) tuples."""
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    return [(nchw(b), nchw(c), nchw(a)) for b, c, a in zip(out["box"], out["cls"], out["angle"])]


@pytest.mark.parametrize("size", ["p", "n"])
def test_head_maps_equal_the_reference(cases, size):
    _, lb, model = cases[size]
    want = REF.head_maps(REF.state_from_numpy(export_ultralytics_state(model), "cpu"), lb, size)
    got = _as_reference_maps(_port_maps(model, lb))
    for (wb, wc, wa), (gb, gc, ga) in zip(want, got):
        for w, g in ((wb, gb), (wc, gc), (wa, ga)):
            assert w.shape == g.shape and float(w.std()) > 0.05  # unit-scale maps, not vanishing ones
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("hw,size", [((240, 320), SIZE), ((1080, 1920), 640)], ids=["240x320-160", "1080p-640"])
def test_the_letterboxed_u8_input_equals_the_reference(hw, size):
    frames = _frames(1, *hw, seed=8)
    port = torch.round(preprocess_fused(frames, size) * 255.0).to(torch.uint8)
    ref = REF.letterbox(frames, size)
    assert torch.equal(port, ref)
    assert int((ref == REF.PAD_GRAY).all(-1).sum()) > 0  # the pad is there


def _ulp_close(got, want):
    atol = ULPS * float(np.spacing(np.float32(np.abs(want).max())))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("size", ["p", "n"])
def test_decode_of_the_same_maps_agrees_within_a_few_ulps(cases, size):
    _, lb, model = cases[size]
    out = _port_maps(model, lb)
    boxes, angle, scores, classes, _ = candidates(out, 16, 0.25)
    dec = REF.decode(_as_reference_maps(out))
    half_w, half_h = dec["w"] / 2, dec["h"] / 2
    xyxy = torch.stack([dec["cx"] - half_w, dec["cy"] - half_h, dec["cx"] + half_w, dec["cy"] + half_h], -1)
    _ulp_close(boxes.numpy(), xyxy.numpy())
    _ulp_close(angle.numpy(), dec["angle"].numpy())
    assert torch.equal(classes, dec["cls"])
    kept = scores > 0
    assert 0 < int(kept.sum()) < kept.numel()  # some anchors below conf
    _ulp_close(scores[kept].numpy(), torch.sigmoid(dec["logit"])[kept].numpy())
    assert torch.equal(kept, torch.sigmoid(dec["logit"]) >= 0.25)


@pytest.mark.parametrize("size", ["p", "n"])
def test_the_reference_nms_picks_as_decode_does(cases, size):
    _, lb, model = cases[size]
    out = _port_maps(model, lb)
    found = candidates(out, 16, 0.25)
    boxes, angle, scores, classes, _ = found
    served = select(*found, SIZE, iou_thresh=0.45, max_det=32, nms_pool=512)
    b5 = torch.stack([(boxes[..., 0] + boxes[..., 2]) / 2, (boxes[..., 1] + boxes[..., 3]) / 2,
                      boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1], angle], -1)
    for i in range(len(scores)):
        picks = REF.greedy_nms(b5[i], scores[i], classes[i], 0.45, 32, 512)
        # a case without near-ties: no pick and pool candidate of its class within 1e-5 of the
        # threshold, where float32 (the port) and float64 (the reference) ProbIoU could part
        _, idx = _top_pool(scores[i:i + 1], 512)
        pool = idx[0][scores[i, idx[0]] > 0]
        same = classes[i, picks][:, None] == classes[i, pool][None, :]
        iou = REF.probiou(b5[i, picks][:, None], b5[i, pool][None, :])
        assert float((iou[same] - 0.45).abs().min()) > 1e-5
        valid = served["valid"][i]
        assert len(picks) == int(valid.sum()) > 1
        assert torch.equal(served["cls"][i][valid], classes[i, picks].to(torch.int32))
        assert torch.equal(served["xyxy"][i][valid], boxes[i, picks])
        assert torch.equal(served["score"][i][valid], scores[i, picks])


@pytest.mark.parametrize("size", ["p", "n"])
def test_the_reference_layer_list_names_every_tensor_of_the_model(size):
    want = {k: tuple(v.shape) for k, v in create_model(15, size, "obb").state_dict().items()}
    got = {}
    for name, c_in, c_out, k, _, head in REF.conv_layers(size, 15):
        if head:
            got.update({f"{name}.weight": (c_out, c_in, k, k), f"{name}.bias": (c_out,)})
        else:
            got[f"{name}.conv.weight"] = (c_out, c_in, k, k)
            got.update({f"{name}.bn.{t}": (c_out,) for t in ("weight", "bias", "running_mean", "running_var")})
    assert got == want


def test_the_benchmark_weights_load_through_the_port_pt_importer(tmp_path):
    """The benchmark's seeded ultralytics-layout weights, calibrated by the
    reference's forward, read by the port's ``.pt`` loader: every tensor
    mapped, and the port's float32 head maps equal the reference's."""
    import warnings

    from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import load_checkpoint

    sys.path.insert(0, str(REPO / "benchmark"))
    try:
        spec = importlib.util.spec_from_file_location("bench_yolo_adapter", REPO / "benchmark" / "systems" / "yolo.py")
        adapter = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(adapter)
    finally:
        sys.path.remove(str(REPO / "benchmark"))
    cfg = {"size": "p", "num_classes": 15}
    lb = REF.letterbox(_frames(), SIZE)
    state = adapter.make_state(cfg, REF, 2**31 + 5)
    adapter.calibrate(REF, state, lb, "p")
    path = str(tmp_path / "w.pt")
    torch.save({"model": state, "names": [f"c{i}" for i in range(15)], "task": "obb"}, path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a partial import warns
        model, meta = load_checkpoint(path)
    assert (meta["task"], meta["size"], len(meta["names"])) == ("obb", "p", 15)
    want = REF.head_maps(state, lb, "p")
    for (wb, wc, wa), (gb, gc, ga) in zip(want, _as_reference_maps(_port_maps(model, lb))):
        for w, g in ((wb, gb), (wc, gc), (wa, ga)):
            assert float(w.std()) > 0.05
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4)
    # the head's outputs at the recipe's scale
    assert max(float(torch.cat([t.flatten() for t in maps]).abs().max()) for maps in want) == pytest.approx(
        adapter.HEAD_MAX, rel=1e-5)


def _conv_macs(model, size):
    macs = [0]

    def count(mod, args, out):
        macs[0] += out.numel() * mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size))
    for h in hooks:
        h.remove()
    return macs[0]


def test_forward_flops_counts_every_conv_and_meets_ultralytics_figure():
    cfg = {"size": "n", "image_size": 640, "num_classes": 15}
    anchors = sum((640 // s) ** 2 for s in (8, 16, 32))
    # every conv of the port's model, and the DFL's 16-tap conv the port computes as an expectation
    assert REF.forward_flops(cfg) == 2 * (_conv_macs(create_model(15, "n", "obb"), 640) + 4 * 16 * anchors)
    # ultralytics: 23.3 GFLOPs at 1024 for the yaml (nc 80), linear in the pixels
    published = 23.3e9 * (640 / 1024) ** 2
    assert math.isclose(REF.forward_flops({**cfg, "num_classes": 80}), published, rel_tol=0.02)


def test_the_reference_imports_neither_jax_nor_the_port_and_turns_tf32_off():
    code = f"""
import importlib.util, json, sys, torch
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
spec = importlib.util.spec_from_file_location("ref", {str(REF_PATH)!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({{"mods": sorted(m for m in sys.modules if m.split(".")[0] in
                                 ("jax", "jaxlib", "flax", "cuauv_vision_pipeline_tpu",
                                  "cuauv_vision_pipeline_tpu_torch")),
                  "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"mods": [], "tf32": [False, False]}
