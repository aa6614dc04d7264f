"""The port's YOLO checkpoint I/O against the JAX package's: the pure-Python
msgpack reader gives flax's tree bit for bit; the port's state-dict names
are ``export_ultralytics_state``'s; ``params_from_flax`` carries every
tensor across exactly; ``.pt`` import reports and checks as the JAX
package's does."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo.model import YOLO as JYOLO
from cuauv_vision_pipeline_tpu.models.yolo.weights import export_ultralytics_state
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import YOLO
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import (
    load_checkpoint,
    msgpack_restore,
    params_from_flax,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["synth_pico_detect", "gate_pico_detect", "synth_pico_segment"])
def test_msgpack_reader_matches_flax(name):
    with open(os.path.join(FIXTURES, f"{name}.msgpack"), "rb") as fh:
        raw = fh.read()
    got = dict(_leaves(msgpack_restore(raw)))
    want = dict(_leaves(serialization.msgpack_restore(raw)))
    assert list(got) == list(want) and len(got) > 200
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


def _flax_tree(task, size, nc=15, seed=None):
    """The flax variable tree of a YOLO, by shape only (no init compile);
    leaves zero, or seeded random values."""
    shapes = jax.eval_shape(JYOLO(num_classes=nc, size=size, task=task).init,
                            jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.normal(size=s.shape) if seed is not None
                                   else np.zeros(s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("size", ["p", "n"])
@pytest.mark.parametrize("task", ["detect", "obb", "pose", "segment", "classify"])
def test_state_dict_names_are_export_ultralytics_state(task, size):
    want = export_ultralytics_state(_flax_tree(task, size), task)
    own = YOLO(15, size, task).state_dict()
    assert set(own) == set(want)
    for key, w in want.items():
        assert tuple(own[key].shape) == w.shape, key
    if (task, size) == ("obb", "n"):  # YOLOv8n-obb, 15 classes
        assert sum(v.numel() for v in own.values()) == 3085424 + sum(
            v.numel() for k, v in own.items() if k.endswith(("running_mean", "running_var")))


@pytest.mark.parametrize("task", ["detect", "obb", "pose", "segment", "classify"])
def test_params_from_flax_equals_export(task):
    tree = _flax_tree(task, "p", seed=3)
    want = export_ultralytics_state(tree, task)
    got = params_from_flax(tree, task)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
    YOLO(15, "p", task).load_state_dict(got)  # strict


def test_load_fixture_checkpoint():
    path = os.path.join(FIXTURES, "synth_pico_detect.msgpack")
    model, meta = load_checkpoint(path)
    assert meta["task"] == "detect" and meta["names"] == ["disc", "slab"]
    assert (model.task, model.size, model.num_classes) == ("detect", "p", 2)
    with open(path, "rb") as fh:
        want = export_ultralytics_state(serialization.msgpack_restore(fh.read()), "detect")
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


def test_pt_import_reports_and_checks(tmp_path, capsys):
    src = YOLO(15, "p", "obb")
    torch.nn.init.normal_(src.model["22"].cv4[0][2].weight)
    state = {k: v.clone() for k, v in src.state_dict().items()}
    state["model.22.dfl.conv.weight"] = torch.arange(16.0).view(1, 16, 1, 1)  # ignored
    path = tmp_path / "w.pt"
    torch.save({"model": state, "names": {i: f"c{i}" for i in range(15)}}, path)
    model, meta = load_checkpoint(str(path))
    out = capsys.readouterr().out
    n = len(src.state_dict())
    assert f"[yolo] .pt import (obb/p): {n} tensors mapped, 0 missing, 0 shape-mismatched" in out
    assert meta == {"task": "obb", "size": "p", "names": [f"c{i}" for i in range(15)]}
    for key, value in src.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key

    del state["model.22.cv3.0.2.bias"]
    torch.save({"model": state, "task": "obb"}, path)
    with pytest.warns(RuntimeWarning, match="1 expected tensors missing"):
        load_checkpoint(str(path))


def test_unreadable_checkpoint_names_its_path(tmp_path):
    path = tmp_path / "broken.msgpack"
    path.write_bytes(b"\x82\xa3not a flax tree")
    with pytest.raises(RuntimeError, match="broken.msgpack"):
        load_checkpoint(str(path))
