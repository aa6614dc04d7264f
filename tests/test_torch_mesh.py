"""The port's (data, model) mesh against the JAX package's, on the CPU.

* ``make_mesh`` and ``param_shardings`` against the JAX rule
  (``tests/test_parallel.py``'s shapes, transposed to torch's layout) and
  over the whole YOLOv8n detect model: the same kernels split.
* The dp2 x tp2 train step on four ``gloo`` ranks (spawned by
  ``parallel.mesh.launch``, ``file://`` rendezvous) in float64, YOLOv8n
  detect, 4 classes, 64 px, batch 4, the dry run's seed-0 inputs, the JAX
  model's parameters carried over by ``params_from_flax``:
  against the port's one-process step on the global batch, loss rtol 1e-9,
  every updated parameter, gradient and running statistic within 1e-9 of
  its norm, replicated tensors equal on every rank and split ones equal
  across the data group; against the JAX one-device ``make_train_step`` on
  the global batch (what GSPMD computes), at the float64 bounds of
  tests/test_torch_yolo_train.py: loss rtol 1e-9, gradients within 1e-6
  of their norms, running statistics rtol 1e-9.
* ``dryrun_multichip(4, backend="gloo", device="cpu")``: every rank passes
  the JAX dry run's assertions; each rank's camera equals JAX ``chain_one``
  on its frame (area and bbox exact, the centroid within 1e-3 px: int64
  sums on the port, float32 in JAX), every rank's merged list equals JAX
  ``cross_camera_nms`` on the stacked lists exactly, each rank's pose
  ``d2``/``idx`` equal JAX ``detect_describe`` + ``device_match_topk``
  (idx exact, d2 rtol 1e-4, atol 1e-5: tests/test_torch_sift.py's bounds),
  and its train loss and gradients equal the port's one-process float32
  step (loss rtol 1e-5, gradients within 1e-4 of their norms).
* ``launch``'s own bound: two ranks that stall outside any collective are
  terminated once ``timeout_s`` has passed since they joined the group, and
  the launch raises naming them.
"""

import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)
from mesh_ranks import stall

from cuauv_vision_pipeline_tpu.models.yolo import train as jtrain
from cuauv_vision_pipeline_tpu.models.yolo.model import create_model as jcreate
from cuauv_vision_pipeline_tpu.ops.feature import detect_describe as jdetect_describe
from cuauv_vision_pipeline_tpu.parallel import crosscam as jcrosscam
from cuauv_vision_pipeline_tpu.parallel import fanout as jfanout
from cuauv_vision_pipeline_tpu.parallel import mesh as jmesh
from cuauv_vision_pipeline_tpu.utils import sift as jsift
from cuauv_vision_pipeline_tpu_torch import entry
from cuauv_vision_pipeline_tpu_torch.models.yolo import train as ttrain
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import YOLO, create_model
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import params_from_flax, params_to_flax
from cuauv_vision_pipeline_tpu_torch.parallel import mesh as tmesh

CENTROID_ATOL = 1e-3


def within_norm(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(np.linalg.norm(want), 1e-30), (name, err, np.linalg.norm(want))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


# ---------------------------------------------------------------------------
# the layout and the sharding rule
# ---------------------------------------------------------------------------


def test_make_mesh_shapes():
    for kw in ({}, {"dp": 4, "tp": 2}, {"dp": 2, "tp": 4}):
        assert tmesh.make_mesh(8, **kw).shape == dict(jmesh.make_mesh(8, **kw).shape)
    assert tmesh.make_mesh(8, dp=4, tp=2).grid.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(AssertionError):
        tmesh.make_mesh(8, dp=3, tp=2)
    assert tmesh.make_mesh(8).shape == {"data": 8, "model": 1}  # all of it to data


def test_param_shardings_rule():
    """tests/test_parallel.py's kernels in torch's layout ([out, in, kh, kw]),
    a dense and a transposed conv, and their biases."""
    model = nn.ModuleDict({"conv": nn.Conv2d(16, 128, 3), "small": nn.Conv2d(4, 8, 3),
                           "dense": nn.Linear(16, 64), "up": nn.ConvTranspose2d(8, 64, 2, 2)})
    mesh = tmesh.make_mesh(8, dp=4, tp=2)
    got = tmesh.param_shardings(mesh, model, min_channels=64)
    assert got == {"conv.weight": ("model", None, None, None), "conv.bias": (),
                   "small.weight": (), "small.bias": (),
                   "dense.weight": ("model", None), "dense.bias": (),
                   "up.weight": (None, "model", None, None), "up.bias": ()}
    jparams = {"conv": {"kernel": jnp.zeros((3, 3, 16, 128))}, "small": {"kernel": jnp.zeros((3, 3, 4, 8))}}
    jspecs = jmesh.param_shardings(jmesh.make_mesh(8, dp=4, tp=2), jparams, min_channels=64)
    assert jspecs["conv"]["kernel"].spec == jax.sharding.PartitionSpec(None, None, None, "model")
    assert jspecs["small"]["kernel"].spec == jax.sharding.PartitionSpec()
    # odd output channels, or a single model rank: nothing splits
    assert tmesh.param_shardings(tmesh.make_mesh(8, dp=8, tp=1), model, 64)["conv.weight"] == ()
    odd = nn.ModuleDict({"c": nn.Conv2d(4, 99, 1)})
    assert tmesh.param_shardings(tmesh.make_mesh(8, dp=4, tp=2), odd, 8)["c.weight"] == ()


@pytest.mark.parametrize("tp,min_channels", [(2, 32), (4, 64)])
def test_param_shardings_on_yolov8n_match_jax(tp, min_channels):
    """The same kernels of YOLOv8n detect split under both rules."""
    _, variables = jcreate(4, size="n", task="detect", image_size=64)
    jspecs = jmesh.param_shardings(jmesh.make_mesh(8, dp=8 // tp, tp=tp), variables["params"], min_channels)
    want = {path: "model" in tuple(s.spec) for path, s in leaves_of_shardings(jspecs)}
    model = create_model(4, "n", "detect")
    specs = tmesh.param_shardings(tmesh.make_mesh(8, dp=8 // tp, tp=tp), model, min_channels)
    flags = {n: torch.full(p.shape, float("model" in specs[n])) for n, p in model.named_parameters()}
    got = {path: bool(a.all()) for path, a in leaves(params_to_flax(model, flags)["params"])}
    assert set(got) == set(want)
    assert got == want
    assert sum(want.values()) > 20


def leaves_of_shardings(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_of_shardings(v, path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# the dp2 x tp2 train step in float64
# ---------------------------------------------------------------------------


def recording_tx():
    """An optax transformation whose state after a step is that step's
    gradients (the parameters stay as they are)."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def one_process_step(state_dict, inputs, dtype):
    model = YOLO(4, "n", "detect")
    model.load_state_dict(state_dict)
    model.to(dtype)
    loss = ttrain.make_train_step(ttrain.create_train_state(model))(
        *(torch.from_numpy(a).to(dtype) if a.dtype.kind == "f" else torch.from_numpy(a) for a in inputs))
    return model, float(loss)


def check_ranks_agree(ranks, grid, key):
    """Replicated tensors equal on every rank; split ones equal across each
    data group (the same model index)."""
    shardings = ranks[0]["shardings"]
    for name in ranks[0][key]:
        split = "model" in shardings.get(name, ())
        for r, res in enumerate(ranks):
            d, m = res["index"]
            ref = ranks[int(grid[0, m])] if split else ranks[0]
            assert torch.equal(res[key][name], ref[key][name]), (key, name, r)


def test_dp2_tp2_float64_step_equals_one_process_and_jax():
    data = entry.dryrun_data(4)
    inputs = (data["images"].astype(np.float64), data["t_xyxy"].astype(np.float64), data["t_cls"])
    jmodel, variables = jcreate(4, size="n", task="detect", image_size=64)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    state_dict = params_from_flax(variables, "detect")

    ranks = tmesh.launch(entry.mesh_train_rank, 4, "gloo", "cpu", args=(2, 2, inputs, state_dict, torch.float64))
    grid = np.arange(4).reshape(2, 2)
    assert [r["index"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for key in ("params", "grads", "buffers"):
        check_ranks_agree(ranks, grid, key)
    assert len({r["loss"] for r in ranks}) == 1
    shardings = ranks[0]["shardings"]
    assert sum("model" in s for s in shardings.values()) > 20

    model, loss = one_process_step(state_dict, inputs, torch.float64)
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=1e-9)
    params = tmesh.gather_params([r["params"] for r in ranks], grid, shardings)
    grads = tmesh.gather_params([r["grads"] for r in ranks], grid, shardings)
    for name, p in model.named_parameters():
        within_norm(params[name], p.detach(), 1e-9, name)
        within_norm(grads[name], p.grad, 1e-9, name)
    for name, b in model.named_buffers():
        within_norm(ranks[0]["buffers"][name], b, 1e-9, name)

    # the JAX one-device step on the global batch
    with jax.enable_x64(True):
        state = jtrain.TrainState(variables["params"], variables["batch_stats"], None, jnp.zeros((), jnp.int32))
        new, jloss = jax.jit(jtrain.make_train_step(jmodel, recording_tx()))(state, *inputs)
        jgrads, jstats = dict(leaves(new.opt_state)), dict(leaves(new.batch_stats))
    np.testing.assert_allclose(ranks[0]["loss"], float(jloss), rtol=1e-9)
    got = dict(leaves(params_to_flax(model, grads)["params"]))
    assert set(got) == set(jgrads)
    for path, want in jgrads.items():
        within_norm(got[path], want, 1e-6, path)
    got = dict(leaves(params_to_flax(model, ranks[0]["buffers"])["batch_stats"]))
    for path, want in jstats.items():
        np.testing.assert_allclose(got[path], want, rtol=1e-9, atol=1e-12, err_msg=str(path))


# ---------------------------------------------------------------------------
# the dry run's four parts
# ---------------------------------------------------------------------------


def test_dryrun_multichip_on_four_cpu_ranks():
    result = entry.dryrun_multichip(4, backend="gloo", device="cpu")
    data, ranks = result["data"], result["ranks"]
    assert (result["dp"], result["tp"]) == (2, 2) and np.isfinite(result["loss"])
    assert len(ranks) == 4

    # 1) the train step against the port's one-process float32 step
    inputs = (data["images"], data["t_xyxy"], data["t_cls"])
    model, loss = one_process_step(create_model(4, "n", "detect").state_dict(), inputs, torch.float32)
    np.testing.assert_allclose(result["loss"], loss, rtol=1e-5)
    grads = tmesh.gather_params([r["grads"] for r in ranks], np.arange(4).reshape(2, 2), ranks[0]["shardings"])
    for name, p in model.named_parameters():
        within_norm(grads[name], p.grad, 1e-4, name)

    # 2) each rank's camera against JAX chain_one on its frame
    for cam, r in enumerate(ranks):
        want = {k: np.asarray(v) for k, v in jax.jit(jfanout.chain_one)(
            jnp.asarray(data["frames"][cam]), jnp.uint8(140), jnp.uint8(255)).items()}
        np.testing.assert_array_equal(r["fan"]["area"], want["area"])
        np.testing.assert_array_equal(r["fan"]["bbox"], want["bbox"])
        np.testing.assert_allclose(r["fan"]["centroid"], want["centroid"], rtol=1e-5, atol=CENTROID_ATOL)

    # 3) each rank's pose front end against JAX's
    _, des_t, n_t = jdetect_describe(jnp.asarray(data["template"]), 32, 0.01, 4)
    prep = jsift.prepare_descriptors(np.asarray(des_t)[:int(n_t)], "query")
    for cam, r in enumerate(ranks):
        _, des, n = jdetect_describe(jnp.asarray(data["grays"][cam]), 128, 0.01, 4)
        jd2, jidx = (np.asarray(a) for a in jsift.device_match_topk(prep, des, n))
        nq = r["pose"]["n_query"]
        assert nq == prep[1]
        np.testing.assert_array_equal(r["pose"]["idx"][:nq], jidx[:nq])
        np.testing.assert_allclose(r["pose"]["d2"][:nq], jd2[:nq], rtol=1e-4, atol=1e-5)

    # 4) every rank's merged list against JAX cross_camera_nms
    want = np.asarray(jcrosscam.cross_camera_nms(jnp.asarray(data["dets"]), max_det=entry.DRYRUN_MAX_DET))
    for r in ranks:
        np.testing.assert_array_equal(r["merged"], want)
    # the CPU takes every kernel's plain version: nothing launched
    assert all(n == 0 for r in ranks for n in r["launches"].values())


def test_launch_raises_on_stalled_ranks_and_leaves_none():
    timeout_s = 15.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank 0 \(pid \d+\), rank 1 \(pid \d+\) still running 15 s "
                                           r"after every rank joined the group") as err:
        tmesh.launch(stall, 2, "gloo", "cpu", args=(3600.0,), timeout_s=timeout_s)
    elapsed = time.monotonic() - t0
    assert timeout_s <= elapsed < tmesh.STARTUP_S + timeout_s
    pids = [int(pid) for pid in re.findall(r"pid (\d+)", str(err.value))]
    assert len(pids) == 2
    assert not [pid for pid in pids if os.path.exists(f"/proc/{pid}")], "a rank process is left"
