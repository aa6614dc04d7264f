"""The port's pose, segment and classify YOLO against the JAX package's, on
the same parameters (carried over by ``params_from_flax``) and the same
numpy inputs, on the CPU at size ``p`` and 64-128 px.

Tolerances: head maps (per scale, NHWC; segment's ``proto``, classify's
``logits``) within rtol = atol = 1e-4, unfused and folded; the ConvTranspose
layout within 1e-5 of flax's; ``compose_masks`` within 1e-6; keypoints
within 1e-4; masks equal but at pixels whose probability lies within 1e-5 of
0.5; ``summarize`` equal; classify probabilities within 1e-5 with the top 5
equal; the trained segment fixture in float32 with ``valid``/``cls`` exact,
``xyxy`` within 1e-2 px and mask IoU >= 0.99 per detection.
"""

import os
import time
import uuid

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo import decode as jdecode
from cuauv_vision_pipeline_tpu.models.yolo.model import YOLO as JYOLO
from cuauv_vision_pipeline_tpu.models.yolo.model import create_model as jcreate
from cuauv_vision_pipeline_tpu.models.yolo.predictor import YoloModel as JYoloModel
from cuauv_vision_pipeline_tpu_torch.core import shm as tshm
from cuauv_vision_pipeline_tpu_torch.models.yolo import decode as tdecode
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import YOLO
from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import render_scene
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import (
    _to_torch_layout,
    load_checkpoint,
    msgpack_restore,
    params_from_flax,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SEG_FIXTURE = os.path.join(FIXTURES, "synth_pico_segment.msgpack")
SEG_KW = dict(image_size=128, max_det=8, conf_thresh=0.25)
NC = 4


def redraw(tree, seed=0):
    """Every leaf redrawn from a seeded generator (init's activations are
    tiny): kernels of unit output variance, the rest in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        if x.ndim >= 2:  # HWIO kernels, the Dense kernel (in, out)
            return rng.normal(0, 1 / np.sqrt(np.prod(x.shape[:-1])), x.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def flax_models():
    """name -> (flax module, variables, task, num_classes)."""
    out = {}
    for task in ("pose", "segment", "classify"):
        model, variables = jcreate(NC, size="p", task=task, image_size=64)
        variables = jax.tree.map(np.asarray, variables)
        out[f"init_{task}"] = (model, variables, task, NC)
        out[f"redrawn_{task}"] = (model, redraw(variables), task, NC)
    with open(SEG_FIXTURE, "rb") as fh:
        out["trained_segment"] = (JYOLO(num_classes=2, size="p", task="segment"),
                                  msgpack_restore(fh.read()), "segment", 2)
    return out


def torch_model(variables, task, nc, fused=False, **kw):
    model = YOLO(nc, "p", task, **kw).eval()
    model.load_state_dict(params_from_flax(variables, task))
    if fused:
        model.fuse_(torch.float32)
    return model


def leaves(out):
    """(name, array) of every head map of a forward's output."""
    for key, value in out.items():
        for i, v in enumerate(value if isinstance(value, (list, tuple)) else [value]):
            yield f"{key}[{i}]", np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


_JAX_OUT = {}


@pytest.mark.parametrize("fused", [False, True], ids=["bn", "folded"])
@pytest.mark.parametrize("case", ["init_pose", "redrawn_pose", "init_segment", "redrawn_segment",
                                  "trained_segment", "init_classify", "redrawn_classify"])
def test_head_outputs_match_jax(flax_models, case, fused):
    jmodel, variables, task, nc = flax_models[case]
    x = np.random.default_rng(1).random((2, 64, 64, 3), dtype=np.float32)
    if case not in _JAX_OUT:
        _JAX_OUT[case] = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    want = dict(leaves(_JAX_OUT[case]))
    with torch.no_grad():
        got = dict(leaves(torch_model(variables, task, nc, fused)(torch.from_numpy(x).permute(0, 3, 1, 2))))
    keys = {"segment": {"box", "cls", "mcoef", "proto"}, "pose": {"box", "cls", "kpts"},
            "classify": {"logits"}}[task]
    assert {k.split("[")[0] for k in got} == {k.split("[")[0] for k in want} == keys
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-4, err_msg=name)
    if case.startswith("redrawn"):  # values far from init's near-zero ones
        assert max(np.abs(w).max() for w in want.values()) > 1.0


def test_convtranspose_layout_matches_flax():
    """The ``convT`` carry-over (HWIO -> IOHW, spatially flipped) makes
    torch's ConvTranspose2d compute flax's ConvTranspose (which does not
    flip its kernel)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    k = rng.standard_normal((2, 2, 6, 4)).astype(np.float32)  # flax HWIO
    b = rng.standard_normal(4).astype(np.float32)
    want = nn.ConvTranspose(4, (2, 2), strides=(2, 2), padding="VALID").apply(
        {"params": {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}}, jnp.asarray(x))
    w = torch.from_numpy(np.ascontiguousarray(_to_torch_layout(k, "convT")))
    got = torch.nn.functional.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), w,
                                               torch.from_numpy(b), stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_compose_masks_matches_jax():
    rng = np.random.default_rng(2)
    proto = rng.normal(0, 1, (32, 32, 8)).astype(np.float32)
    coefs = rng.normal(0, 1, (5, 8)).astype(np.float32)
    xy = rng.uniform(-10, 120, (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (5, 2))], 1).astype(np.float32)
    want = np.asarray(jdecode.compose_masks(jnp.asarray(proto), jnp.asarray(coefs), jnp.asarray(boxes), 128))
    got = tdecode.compose_masks(*(torch.from_numpy(a)[None] for a in (proto, coefs, boxes)), 128)[0]
    assert got.shape == want.shape == (5, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want == 0).any() and (want > 0.5).any()  # the crop and the masks both show


def assert_masks_equal_off_the_cut(got, want, prob):
    """u8 masks equal except where the mask probability lies within 1e-5 of
    0.5 (the two libraries' sigmoid and sums round apart there)."""
    near = np.abs(prob - 0.5) <= 1e-5
    np.testing.assert_array_equal(np.where(near, 0, got), np.where(near, 0, want))


def _decode_both(case, flax_models, image_size=64):
    """One forward's head maps (JAX's) decoded by both packages, float32."""
    jmodel, variables, task, _ = flax_models[case]
    x = np.random.default_rng(3).random((1, image_size, image_size, 3), dtype=np.float32)
    heads = jax.tree.map(np.array, jmodel.apply(variables, jnp.asarray(x)))
    kw = dict(conf_thresh=0.0 if case.startswith("init") else 0.25, max_det=8)
    want = jax.tree.map(np.asarray, jdecode.decode(heads, image_size, **kw))
    theads = {k: [torch.from_numpy(v) for v in vs] if isinstance(vs, list) else torch.from_numpy(vs)
              for k, vs in heads.items()}
    got = {k: v[0].numpy() for k, v in tdecode.decode(theads, image_size, **kw).items()}
    return heads, got, want


@pytest.mark.parametrize("case", ["redrawn_pose", "redrawn_segment", "trained_segment"])
def test_decode_keypoints_and_masks_match_jax(flax_models, case):
    heads, got, want = _decode_both(case, flax_models, 128 if case == "trained_segment" else 64)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["xyxy"], want["xyxy"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5, atol=1e-5)
    assert want["valid"].any()
    if "kpts" in want:
        assert got["kpts"].shape == want["kpts"].shape == (8, 17, 3)
        np.testing.assert_allclose(got["kpts"], want["kpts"], rtol=1e-4, atol=1e-4)
    if "mask" in want:
        assert got["mask"].dtype == want["mask"].dtype == np.uint8
        image_size = heads["proto"].shape[1] * 4
        flat = jdecode._flatten_scales(heads, image_size)
        coefs = flat["mcoef"][0][_jax_winners(flat, image_size, 0.25, 8)]
        prob = np.asarray(jdecode.compose_masks(jnp.asarray(heads["proto"][0]), coefs,
                                                jnp.asarray(want["xyxy"]), image_size))
        assert_masks_equal_off_the_cut(got["mask"], want["mask"], prob)
        assert want["mask"].sum() > 0


def _jax_winners(flat, image_size, conf_thresh, max_det):
    """The anchor index behind each of JAX decode's slots (its own steps:
    threshold, top-k pool, NMS)."""
    boxes, _ = jdecode.decode_boxes(flat)
    cls = flat["cls"][0]
    scores = jax.nn.sigmoid(cls.max(-1))
    scores, top_idx = jax.lax.top_k(jnp.where(scores >= conf_thresh, scores, 0.0), min(512, cls.shape[0]))
    picked, _ = jdecode.nms_fixed(boxes[top_idx], scores, cls.argmax(-1)[top_idx], 0.45, max_det)
    return top_idx[jnp.maximum(picked, 0)]


def test_summarize_pose_and_segment_equal_jax(flax_models):
    for case, task in (("redrawn_pose", "pose"), ("trained_segment", "segment")):
        _, got, want = _decode_both(case, flax_models, 128 if task == "segment" else 64)
        kw = dict(scale=(2.5, 2.5), task=task, pad=(0.0, 16.0), clip_wh=(160.0, 120.0),
                  image_size=128 if task == "segment" else 64)
        mine = tdecode.summarize(want, ["a", "b", "c", "d"], **kw)
        theirs = jdecode.summarize(want, ["a", "b", "c", "d"], **kw)
        assert mine == theirs and mine
        assert all(("keypoints" if task == "pose" else "segments") in e for e in mine)
        if task == "segment":
            assert any(len(e["segments"]["x"]) >= 3 for e in mine)


def test_classify_probabilities_match_jax(flax_models):
    """Classify through both predictors (f32): probabilities within 1e-5,
    the top 5 equal, and the tracker left alone."""
    _, variables, _, _ = flax_models["redrawn_classify"]
    names = [f"c{i}" for i in range(NC)]
    jm = JYoloModel(None, task="classify", size="p", class_names=names, image_size=64,
                    half_precision=False)
    jm._infer_vars = variables
    tm = YoloModel(None, task="classify", size="p", class_names=names, image_size=64,
                   half_precision=False, device="cpu")
    tm.model.load_state_dict(params_from_flax(variables, "classify"))
    tm.to("cpu")
    for seed in range(3):
        img = np.random.default_rng(seed).integers(0, 255, (48, 80, 3), np.uint8)
        want = np.asarray(jm.device_decode(img)["probs"])
        got = tm.device_decode(img)["probs"].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert np.abs(want - 1 / NC).max() > 1e-2  # not a uniform guess
        mine = tm.summarize_decoded({"probs": got}, (48, 80))
        theirs = jm.summarize_decoded({"probs": want}, (48, 80))
        assert [(e["name"], e["class"]) for e in mine] == [(e["name"], e["class"]) for e in theirs]
        assert [e["confidence"] for e in mine] == pytest.approx([e["confidence"] for e in theirs], abs=1e-5)
    results = tm.track(img)[0].summary()
    assert [r["name"] for r in results] == [names[i] for i in np.argsort(want)[::-1][:5]]
    assert tm._tracker.tracks == [] and "track_id" not in results[0]


@pytest.fixture(scope="module")
def seg_scenes():
    rng = np.random.default_rng(77)
    return [render_scene(rng, size=128, max_objects=3, with_masks=True) for _ in range(4)]


def mask_iou(a, b) -> float:
    a, b = a.astype(bool), b.astype(bool)
    return float((a & b).sum() / max((a | b).sum(), 1))


def test_segment_fixture_f32_matches_jax(seg_scenes):
    jm = JYoloModel(SEG_FIXTURE, half_precision=False, **SEG_KW)
    tm = YoloModel(SEG_FIXTURE, half_precision=False, device="cpu", **SEG_KW)
    assert tm.task == "segment" and tm.class_names == ["disc", "slab"]
    n = 0
    for img, _, _, _ in seg_scenes:
        want = {k: np.asarray(v) for k, v in jm.device_decode(img).items()}
        got = {k: v.numpy() for k, v in tm.device_decode(img).items()}
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["cls"], want["cls"])
        np.testing.assert_allclose(got["xyxy"], want["xyxy"], atol=1e-2)
        assert got["mask"].shape == want["mask"].shape == (8, 32, 32)
        for i in np.nonzero(want["valid"])[0]:
            assert mask_iou(got["mask"][i], want["mask"][i]) >= 0.99
            n += 1
        assert not got["mask"][~got["valid"]].any()
    assert n >= 4


def test_segment_through_the_two_camera_dispatch(seg_scenes):
    """Each camera's lane of ``device_decode_multi`` carries its own masks,
    equal to that camera decoded alone."""
    tm = YoloModel(SEG_FIXTURE, half_precision=False, device="cpu", **SEG_KW)
    cams = [seg_scenes[0][0], np.ascontiguousarray(seg_scenes[1][0][16:112])]
    multi = tm.device_decode_multi(cams)
    assert multi["mask"].shape == (2, 8, 32, 32) and multi["mask"].dtype == torch.uint8
    for i, cam in enumerate(cams):
        alone = tm.device_decode(cam)
        assert torch.equal(multi["valid"][i], alone["valid"]) and alone["valid"].any()
        assert torch.equal(multi["mask"][i], alone["mask"])


def test_pose_pt_import_infers_the_task_and_keypoints(tmp_path, capsys):
    """A .pt with no declared task: a 3*nk-wide cv4 reads as pose with nk
    keypoints, a Proto as segment, a classify Linear as classify."""
    for task, kw, want_task in (("pose", dict(num_keypoints=4), "pose"), ("segment", {}, "segment"),
                                ("classify", {}, "classify")):
        src = YOLO(3, "p", task, **kw)
        path = tmp_path / f"{task}.pt"
        torch.save({"model": src.state_dict()}, path)
        model, meta = load_checkpoint(str(path))
        assert meta["task"] == want_task and model.num_classes == 3
        assert "0 missing, 0 shape-mismatched" in capsys.readouterr().out
        if task == "pose":
            assert model.num_keypoints == 4
        for key, value in src.state_dict().items():
            assert torch.equal(model.state_dict()[key], value), key


def test_segment_module_serves_onto_shm(monkeypatch, unique_direction):
    """modules.yolo in-process with the segment fixture as its weight:
    one frame through its chain (letterbox, forward, decode with masks)
    and its host leg advances ``shm.yolo_status``."""
    from cuauv_vision_pipeline_tpu_torch.core.base import DeviceResultMeta
    from cuauv_vision_pipeline_tpu_torch.modules import yolo

    monkeypatch.setenv(tshm.NAMESPACE_ENV, f"test-{uuid.uuid4().hex[:10]}")
    module = yolo.Yolo([unique_direction], yolo.TUNERS, yolo.HANDLERS, weight=SEG_FIXTURE,
                       argv=["--device", "cpu"])
    try:
        assert module.yolo_model_type == "segment"
        img = render_scene(np.random.default_rng(5), size=128, max_objects=3)[0]
        decoded, posts = module.detect_chain(torch.from_numpy(img), tuners={}, want_posts=True)
        assert decoded["mask"].dtype == torch.uint8 and decoded["mask"].shape[1:] == (160, 160)
        meta = DeviceResultMeta(aliases=(unique_direction,), acquisition_time=int(time.monotonic() * 1000),
                                submit_time=time.monotonic())
        module.on_device_result({k: v.numpy() for k, v in decoded.items()},
                                {k: v.numpy() for k, v in posts.items()}, meta)
        assert tshm.yolo_status.get().frames == 1
    finally:
        for name in ("active_objects", "yolo_status"):
            tshm.delete_group(name)


def test_classify_is_refused_by_the_module(monkeypatch, tmp_path, unique_direction):
    from cuauv_vision_pipeline_tpu_torch.modules import yolo

    path = tmp_path / "cls.pt"
    torch.save({"model": YOLO(3, "p", "classify").state_dict()}, path)
    with pytest.raises(ValueError, match="Whole-frame classifiers serve via YoloModel.predict"):
        yolo.Yolo([unique_direction], yolo.TUNERS, yolo.HANDLERS, weight=str(path), argv=["--device", "cpu"])


@pytest.mark.parametrize("hw", [(1080, 1920), (720, 1280), (600, 800), (640, 640)])
def test_fused_letterbox_equals_the_jax_gather_form(hw):
    """The port's one letterbox, ``preprocess_fused``, equals the JAX
    package's gather-form ``preprocess`` (``entry()``'s) at the u8 level at
    the serving sizes."""
    from cuauv_vision_pipeline_tpu.models.yolo.model import preprocess as jpreprocess
    from cuauv_vision_pipeline_tpu_torch.models.yolo.model import preprocess_fused

    img = np.random.default_rng(hw[1]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got = preprocess_fused(torch.from_numpy(img)[None], 640).numpy()
    want = np.asarray(jax.jit(jpreprocess, static_argnums=1)(jnp.asarray(img)[None], 640))
    assert got.shape == want.shape == (1, 640, 640, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(np.rint(got * 255), np.rint(want * 255))


def test_segment_lanes_and_the_packed_fetch(seg_scenes):
    """A batched dispatch carries each lane's masks; the decode dict goes
    through the executor's one-copy packing with the masks as u8 bytes, and
    summarize reads the unpacked dict as the decoded one."""
    from cuauv_vision_pipeline_tpu_torch.engine.executor import pack_result, unpack_result

    tm = YoloModel(SEG_FIXTURE, half_precision=False, device="cpu", **SEG_KW)
    frames = np.stack([s[0] for s in seg_scenes[:2]])
    batch = tm.device_decode_batch(frames)
    assert batch["mask"].shape == (2, 8, 32, 32)
    for lane in range(2):
        assert torch.equal(batch["mask"][lane], tm.device_decode(frames[lane])["mask"])
    decoded = {k: v[0] for k, v in batch.items()}
    packed, spec = pack_result(decoded)
    assert packed.numel() == sum(-(-v.numel() * v.element_size() // 8) * 8 for v in decoded.values())
    back = unpack_result(packed.numpy(), spec)
    assert back["mask"].dtype == np.uint8
    np.testing.assert_array_equal(back["mask"], decoded["mask"].numpy())
    direct = tm.summarize_decoded({k: v.numpy() for k, v in decoded.items()}, (128, 128))
    assert tm.summarize_decoded(back, (128, 128)) == direct and direct
    assert all(len(e["segments"]["x"]) >= 3 for e in direct)
