"""The port's checkpoint writer and the ultralytics export/import against the
JAX package's, on the CPU: ``params_to_flax`` inverts ``params_from_flax``;
the msgpack writer gives flax's bytes; ``save_checkpoint``'s files load in
the JAX package's ``load_checkpoint`` with every array equal and serve
through the port's ``YoloModel``; ``export_ultralytics_state`` and
``map_ultralytics_state``'s report equal the JAX package's. Every
comparison is exact."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo import weights as jweights
from cuauv_vision_pipeline_tpu.models.yolo.model import YOLO as JYOLO
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import YOLO
from cuauv_vision_pipeline_tpu_torch.models.yolo.predictor import YoloModel
from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import render_scene
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import (
    export_ultralytics_state,
    load_checkpoint,
    map_ultralytics_state,
    msgpack_restore,
    msgpack_serialize,
    params_from_flax,
    params_to_flax,
    save_checkpoint,
)

TASKS = ("detect", "obb", "pose", "segment", "classify")
NC = 3


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def flax_tree(task, seed):
    """A flax YOLO variable tree (size p) by shape only, with seeded random
    values."""
    shapes = jax.eval_shape(JYOLO(num_classes=NC, size="p", task=task).init,
                            jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


def torch_model(task, seed=1):
    model = YOLO(NC, "p", task)
    model.load_state_dict(params_from_flax(flax_tree(task, seed), task))
    return model.eval()


def assert_trees_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and got[path].shape == w.shape, path
        assert np.array_equal(got[path], w), path


@pytest.mark.parametrize("task", TASKS)
def test_params_to_flax_inverts_params_from_flax(task):
    tree = flax_tree(task, seed=3)
    model = YOLO(NC, "p", task)
    model.load_state_dict(params_from_flax(tree, task))
    assert_trees_equal(params_to_flax(model), tree)
    # the arrays are copies: the module's later updates leave them alone
    out = params_to_flax(model)
    with torch.no_grad():
        model.model["0"].bn.bias.add_(1.0)
    np.testing.assert_array_equal(out["params"]["ConvBnSilu_0"]["BatchNorm_0"]["bias"],
                                  tree["params"]["ConvBnSilu_0"]["BatchNorm_0"]["bias"])


@pytest.mark.parametrize("task", TASKS)
def test_msgpack_writer_gives_flax_bytes(task):
    tree = params_to_flax(torch_model(task))
    raw = msgpack_serialize(tree)
    assert raw == serialization.msgpack_serialize(tree)
    assert_trees_equal(msgpack_restore(raw), tree)


def test_msgpack_writer_encodings():
    """Lengths at each msgpack size class, and arrays of other dtypes and
    ranks, read back by flax."""
    tree = {"s" * 31: np.zeros((), np.float32), "t" * 32: np.arange(3, dtype=np.int32),
            "u" * 300: {f"k{i}": np.full((2, 1), i, np.float64) for i in range(17)},
            "big": np.arange(70000, dtype=np.float32).reshape(7, 10000), "one": np.ones(1, np.uint8)}
    raw = msgpack_serialize(tree)
    assert raw == serialization.msgpack_serialize(tree)
    assert_trees_equal(serialization.msgpack_restore(raw), tree)


@pytest.mark.parametrize("task", ["detect", "segment"])
def test_save_checkpoint_loads_in_jax_and_serves(tmp_path, task):
    model = torch_model(task)
    path = str(tmp_path / f"{task}.msgpack")
    names = [f"c{i}" for i in range(NC)]
    save_checkpoint(path, model, {"names": names, "image_size": 64})
    with open(path + ".json") as fh:
        meta = json.load(fh)
    assert meta == {"task": task, "size": "p", "num_classes": NC, "num_keypoints": 17, "num_masks": 32,
                    "names": names, "image_size": 64}
    jmodel, variables, jmeta = jweights.load_checkpoint(path)
    assert (jmodel.task, jmodel.size, jmodel.num_classes, jmeta["names"]) == (task, "p", NC, names)
    assert_trees_equal(jax.tree.map(np.asarray, variables), params_to_flax(model))
    back, back_meta = load_checkpoint(path)
    assert back_meta == meta
    for key, value in model.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
    serve = YoloModel(path, half_precision=False, device="cpu")
    assert serve.image_size == 64 and serve.task == task and serve.class_names == names
    img = render_scene(np.random.default_rng(0), size=64)[0]
    decoded = serve.device_decode(img)
    assert decoded["valid"].shape == (32,) and torch.isfinite(decoded["score"]).all()


def test_save_checkpoint_without_image_size(tmp_path):
    path = str(tmp_path / "w.msgpack")
    save_checkpoint(path, torch_model("classify"), {"names": ["a", "b", "c"]})
    with open(path + ".json") as fh:
        meta = json.load(fh)
    assert "image_size" not in meta and meta["task"] == "classify"
    assert YoloModel(path, half_precision=False, device="cpu").image_size == 640


@pytest.mark.parametrize("task", TASKS)
def test_export_ultralytics_state_equals_jax(task):
    tree = flax_tree(task, seed=5)
    want = jweights.export_ultralytics_state(tree, task)
    model = YOLO(NC, "p", task)
    model.load_state_dict(params_from_flax(tree, task))
    got = export_ultralytics_state(model)
    assert list(got) == list(model.state_dict()) and set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == np.float32 and np.array_equal(got[key], w), key


@pytest.mark.parametrize("task", ["obb", "segment", "classify"])
def test_map_ultralytics_state_report_equals_jax(task):
    """A state dict with an unknown key, a missing tensor and a tensor of
    the wrong shape: the same report as JAX's, the same tensors mapped."""
    src = flax_tree(task, seed=7)
    state = jweights.export_ultralytics_state(src, task)
    state["model.22.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    del state["model.1.bn.running_var"]
    state["model.0.conv.weight"] = state["model.0.conv.weight"][:, :, :1]
    target = flax_tree(task, seed=8)
    jvars, jreport = jweights.map_ultralytics_state(state, target, task)
    model = YOLO(NC, "p", task)
    model.load_state_dict(params_from_flax(target, task))
    own, report = map_ultralytics_state(state, model)
    assert report == jreport == {"mapped": len(own) - 2, "missing": 1, "mismatched": 1}
    model.load_state_dict(own)
    assert_trees_equal(params_to_flax(model), jax.tree.map(np.asarray, jvars))
    # torch tensors map as numpy arrays do
    own_t, report_t = map_ultralytics_state({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()},
                                            model)
    assert report_t == report and all(torch.equal(own_t[k], own[k]) for k in own)


def test_pt_import_uses_map_ultralytics_state(tmp_path, capsys):
    model = torch_model("pose")
    path = str(tmp_path / "w.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in export_ultralytics_state(model).items()},
                "task": "pose"}, path)
    back, meta = load_checkpoint(path)
    n = len(model.state_dict())
    assert f"{n} tensors mapped, 0 missing, 0 shape-mismatched" in capsys.readouterr().out
    assert meta["task"] == "pose" and os.path.getsize(path) > 0
    for key, value in model.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
