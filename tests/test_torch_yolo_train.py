"""The port's YOLO trainer against the JAX package's, on the CPU: the same
numpy inputs, the same parameters (carried over by ``params_from_flax``).

Tolerances:

* train-mode BatchNorm against flax's ``nn.BatchNorm(momentum=0.97,
  epsilon=1e-3)``: output and running mean/var after 1 and 3 steps within
  rtol 1e-5 (atol 1e-6 for running means near 0), the input's and
  parameters' gradients within 1e-5 of their norms;
* each loss on the same head maps: rtol 1e-5, its gradients with respect to
  the maps within 1e-5 of their norms;
* one whole step per task in float64 on both sides (JAX under
  ``enable_x64``): loss rtol 1e-9, every parameter's gradient (mapped
  through ``params_to_flax``) within 1e-6 of its norm, the running
  statistics rtol 1e-9. The float64 step is the semantic check: in float32
  JAX's own gradients stand ~1e-3 of their norm from its float64 ones (the
  first BatchNorm's scale: flax's fast variance E[x^2] - E[x]^2 cancels on
  the images' DC term), so float32 against float32 cannot show 1e-4;
* the detect step in float32: loss rtol 1e-5, running statistics rtol 1e-5
  (atol 5e-6: running means near 0 carry both sides' float32 forward
  noise, ~1e-6), gradients within 5e-3 of their norms (JAX's float32
  noise);
* AdamW against ``optax.adamw`` on identical gradients, 3 steps: rtol 1e-6,
  atol 5e-5 x lr (optax takes its bias corrections in float32: 1 - 0.999
  rounds 1.3e-5 off, so each of its steps is up to ~1.5e-5 of lr off,
  measured; torch takes them in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.models.yolo import train as jtrain
from cuauv_vision_pipeline_tpu.models.yolo.model import create_model as jcreate
from cuauv_vision_pipeline_tpu_torch.entry import train_step_entry
from cuauv_vision_pipeline_tpu_torch.models.yolo import quant
from cuauv_vision_pipeline_tpu_torch.models.yolo import train as ttrain
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import BatchNorm, YOLO, create_model
from cuauv_vision_pipeline_tpu_torch.models.yolo.synth import (
    make_task_batch,
    render_obb_scene,
    render_pose_scene,
    to_model_input,
)
from cuauv_vision_pipeline_tpu_torch.models.yolo.weights import params_from_flax, params_to_flax

S = 64
NC = 3
TASKS = ("detect", "obb", "pose", "segment", "classify")


def tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def assert_within_norm(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(np.linalg.norm(want), 1e-30), (name, err, np.linalg.norm(want))


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


def test_train_mode_batchnorm_equals_flax():
    rng = np.random.default_rng(0)
    C = 6
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.normal(0, 0.5, C).astype(np.float32)
    fbn = nn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    bn = BatchNorm(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    for step in range(3):
        x = rng.normal(0.3 * step, 1.0 + step, (2, 5, 7, C)).astype(np.float32)
        w = rng.normal(0, 1, x.shape).astype(np.float32)

        def f(params, x):
            y, upd = fbn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                               mutable=["batch_stats"])
            return (y * w).sum(), (y, upd["batch_stats"])

        (_, (want, stats)), (g_params, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            variables["params"], jnp.asarray(x))
        variables["batch_stats"] = stats
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        got = bn(xt)
        (got * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)
        assert_within_norm(xt.grad.permute(0, 2, 3, 1).numpy(), g_x, 1e-5, "x")
        assert_within_norm(bn.weight.grad.numpy(), g_params["scale"], 1e-5, "scale")
        assert_within_norm(bn.bias.grad.numpy(), g_params["bias"], 1e-5, "bias")
        bn.weight.grad = bn.bias.grad = None
    # eval mode normalises with the running statistics and moves nothing
    before = bn.running_var.clone()
    bn.eval()(torch.zeros(1, C, 2, 2))
    assert torch.equal(bn.running_var, before)


def test_fused_or_quantized_model_refuses_train():
    model = create_model(NC, "p", "detect")
    model.train()
    model.eval().fuse_(torch.float32)
    with pytest.raises(RuntimeError, match="cannot train"):
        model.train()
    model.eval()  # eval stays allowed
    w8 = create_model(NC, "p", "detect")
    quant.w8a8_(w8, torch.float32)
    with pytest.raises(RuntimeError, match="cannot train"):
        w8.train()


# ---------------------------------------------------------------------------
# the losses on the same head maps
# ---------------------------------------------------------------------------

GRIDS = ((8, 8), (4, 4), (2, 2))  # 64 px at strides 8, 16, 32
T = 4
NK = 5
NM = 8


def head_maps(rng, task):
    maps = {"cls": [rng.normal(0, 2, (2, h, w, NC)) for h, w in GRIDS],
            "box": [rng.normal(0, 2, (2, h, w, 64)) for h, w in GRIDS]}
    if task == "obb":
        maps["angle"] = [rng.normal(0, 2, (2, h, w, 1)) for h, w in GRIDS]
    if task == "pose":
        maps["kpts"] = [rng.normal(0, 1, (2, h, w, 3 * NK)) for h, w in GRIDS]
    if task == "segment":
        maps["mcoef"] = [rng.normal(0, 1, (2, h, w, NM)) for h, w in GRIDS]
        maps["proto"] = rng.normal(0, 1, (2, S // 4, S // 4, NM))
    return {k: ([a.astype(np.float32) for a in v] if isinstance(v, list) else v.astype(np.float32))
            for k, v in maps.items()}


def targets(case):
    """(t_xyxy [2, T, 4], t_cls [2, T]): ``mixed`` has two gts whose centers
    share an anchor (same class, and another class), gts at the image's
    edges and corners (centers clipped into the grid) and padding rows with
    non-zero boxes; ``padding`` is all padding."""
    if case == "padding":
        xyxy = np.zeros((2, T, 4), np.float32)
        xyxy[1, 2] = (10, 10, 30, 30)  # a padding row need not be zero
        return xyxy, np.full((2, T), -1, np.int32)
    xyxy = np.array([[[10, 12, 22, 26], [12, 14, 20, 24], [13, 13, 21, 25], [0, 0, 0, 0]],
                     [[0, 0, 9, 7], [50, 40, 64, 64], [30.5, 0, 64, 3], [5, 5, 25, 25]]], np.float32)
    cls = np.array([[1, 1, 2, -1], [0, 2, 1, -1]], np.int32)
    return xyxy, cls


def extra_targets(rng, task, xyxy):
    if task == "obb":
        return rng.uniform(-np.pi / 4 + 0.01, 3 * np.pi / 4 - 0.01, (2, T)).astype(np.float32)
    if task == "pose":
        k = rng.uniform(0, S, (2, T, NK, 3)).astype(np.float32)
        k[..., 2] = rng.integers(0, 2, (2, T, NK))
        k[0, 0, :, 2] = 0  # a gt with no visible keypoint
        return k
    if task == "segment":
        return (rng.random((2, T, S // 4, S // 4)) < 0.4).astype(np.float32)
    return None


def jax_loss(task, maps, xyxy, cls, extra):
    valid = jnp.asarray(cls) >= 0
    if task == "detect":
        return jtrain.detection_loss(maps, xyxy, cls, NC)
    if task == "detect_angle":
        return jtrain.detection_loss(maps, xyxy, cls, NC, targets_angle=extra)
    if task == "obb":
        return jtrain.obb_angle_loss(maps, xyxy, extra, valid)
    if task == "pose":
        return jtrain.pose_kpt_loss(maps, xyxy, extra, valid)
    return jtrain.segment_loss(maps, xyxy, extra, valid, S)


def torch_loss(task, maps, xyxy, cls, extra):
    valid = (cls >= 0).float()
    if task == "detect":
        return ttrain.detection_loss(maps, xyxy, cls, NC)
    if task == "detect_angle":
        return ttrain.detection_loss(maps, xyxy, cls, NC, targets_angle=extra)
    if task == "obb":
        return ttrain.obb_angle_loss(maps, xyxy, extra, valid)
    if task == "pose":
        return ttrain.pose_kpt_loss(maps, xyxy, extra, valid)
    return ttrain.segment_loss(maps, xyxy, extra, valid, S)


@pytest.mark.parametrize("case", ["mixed", "padding"])
@pytest.mark.parametrize("loss", ["detect", "detect_angle", "obb", "pose", "segment"])
def test_loss_equals_jax(loss, case):
    rng = np.random.default_rng(sum(map(ord, loss + case)))
    map_task = {"detect_angle": "obb"}.get(loss, loss)
    maps = head_maps(rng, map_task)
    xyxy, cls = targets(case)
    extra = extra_targets(rng, "obb" if loss == "detect_angle" else loss, xyxy)
    want, want_g = jax.value_and_grad(lambda m: jax_loss(loss, m, xyxy, cls, extra))(
        jax.tree.map(jnp.asarray, maps))
    tmaps = {k: ([torch.from_numpy(a).requires_grad_() for a in v] if isinstance(v, list)
                 else torch.from_numpy(v).requires_grad_()) for k, v in maps.items()}
    got = torch_loss(loss, tmaps, torch.from_numpy(xyxy), torch.from_numpy(cls),
                     None if extra is None else torch.from_numpy(extra))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for key, value in tmaps.items():
        for i, t in enumerate(value if isinstance(value, list) else [value]):
            w = want_g[key][i] if isinstance(value, list) else want_g[key]
            g = np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
            assert_within_norm(g, w, 1e-5, f"{key}[{i}]")
    if case == "padding" and loss in ("obb", "pose", "segment"):
        assert float(got) == 0.0  # padding contributes nothing


def test_classify_loss_equals_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, 6).astype(np.int32)
    want = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    got = ttrain.classify_loss({"logits": torch.from_numpy(logits)}, torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# one whole step per task
# ---------------------------------------------------------------------------


def recording_tx():
    """An optax transformation whose state after a step is that step's
    gradients (the parameters stay as they are)."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def step_inputs(task):
    rng = np.random.default_rng(11)
    if task == "classify":
        return rng.random((2, S, S, 3)).astype(np.float32), (rng.integers(0, NC, 2).astype(np.int32),)
    batch = make_task_batch(rng, 2, S, task=task)
    return to_model_input(batch[0]), tuple(batch[1:])


def run_both(task, dtype):
    """(JAX's loss, gradients, new batch stats; the port's likewise) for one
    step of ``task`` on seeded inputs, both sides in ``dtype``."""
    kw = {"num_keypoints": 5} if task == "pose" else {}
    jmodel, variables = jcreate(NC, size="p", task=task, image_size=S, **kw)
    variables = jax.tree.map(lambda a: np.asarray(a, dtype), variables)
    images, tgt = step_inputs(task)
    tgt_np = tuple(np.asarray(t, dtype) if np.asarray(t).dtype.kind == "f" else t for t in tgt)
    with jax.enable_x64(dtype == np.float64):
        state = jtrain.TrainState(variables["params"], variables["batch_stats"], None, jnp.zeros((), jnp.int32))
        new, loss = jax.jit(jtrain.make_train_step(jmodel, recording_tx()))(state, images.astype(dtype), *tgt_np)
        want = (float(loss), dict(tree_leaves(new.opt_state)), dict(tree_leaves(new.batch_stats)))
    model = YOLO(NC, "p", task, **kw)
    model.load_state_dict(params_from_flax(variables, task))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    model.to(tdt)
    st = ttrain.create_train_state(model)
    loss = ttrain.make_train_step(st)(torch.from_numpy(images).to(tdt),
                                       *(torch.from_numpy(np.ascontiguousarray(t)) for t in tgt_np))
    assert st.step == 1 and loss.dtype == tdt and loss.ndim == 0
    grads = params_to_flax(model, {n: p.grad for n, p in model.named_parameters()})
    got = (float(loss), dict(tree_leaves(grads["params"])),
           dict(tree_leaves(params_to_flax(model)["batch_stats"])))
    return want, got


@pytest.mark.parametrize("task", TASKS)
def test_one_step_equals_jax_float64(task):
    (jloss, jgrads, jstats), (tloss, tgrads, tstats) = run_both(task, np.float64)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-9)
    assert set(tgrads) == set(jgrads) and len(jgrads) > 50
    for path, w in jgrads.items():
        assert_within_norm(tgrads[path], w, 1e-6, path)
    assert set(tstats) == set(jstats)
    for path, w in jstats.items():
        np.testing.assert_allclose(tstats[path], w, rtol=1e-9, atol=1e-12, err_msg=str(path))


def test_one_step_equals_jax_float32():
    (jloss, jgrads, jstats), (tloss, tgrads, tstats) = run_both("detect", np.float32)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for path, w in jgrads.items():
        assert_within_norm(tgrads[path], w, 5e-3, path)
    for path, w in jstats.items():
        np.testing.assert_allclose(tstats[path], w, rtol=1e-5, atol=5e-6, err_msg=str(path))


def test_adamw_equals_optax():
    model = create_model(NC, "p", "classify", seed=2)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32)))
    st = ttrain.create_train_state(model, learning_rate=2e-3)
    params = params_to_flax(model)["params"]
    tx = optax.adamw(2e-3)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for step in range(3):
        grads = {n: torch.from_numpy(rng.normal(0, 10.0 ** rng.integers(-6, 2), p.shape).astype(np.float32))
                 for n, p in model.named_parameters()}
        grads["model.0.bn.bias"].zero_()  # zero gradients: decay alone
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        st.optimizer.step()
        updates, opt_state = update(params_to_flax(model, grads)["params"], opt_state, params)
        params = optax.apply_updates(params, updates)
        got = dict(tree_leaves(params_to_flax(model)["params"]))
        for path, w in tree_leaves(params):
            np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=5e-5 * 2e-3, err_msg=f"step {step}: {path}")


# ---------------------------------------------------------------------------
# the port's step learns (the JAX package's *_train_step_learns_* tests)
# ---------------------------------------------------------------------------


def fixed_scene(task):
    rng = np.random.default_rng({"detect": 0, "obb": 2, "pose": 3, "segment": 0}[task])
    if task == "obb":
        img, boxes, cls, extra = render_obb_scene(rng, size=S, max_objects=1)
    elif task == "pose":
        img, boxes, cls, extra = render_pose_scene(rng, size=S, max_objects=1)
    elif task == "segment":
        img = rng.integers(0, 255, (S, S, 3), dtype=np.uint8)
        boxes, cls = np.array([[16.0, 24.0, 48.0, 56.0]], np.float32), np.array([0], np.int32)
        extra = np.zeros((1, S // 4, S // 4), np.float32)
        extra[0, 6:14, 4:12] = 1.0
    else:
        img = rng.integers(0, 255, (S, S, 3), dtype=np.uint8)
        boxes = np.array([[8, 8, 24, 24], [32, 32, 56, 56], [0, 0, 0, 0]], np.float32)
        cls, extra = np.array([0, 1, -1], np.int32), None
    parts = (boxes, cls) + (() if extra is None else (extra,))
    return (torch.from_numpy(to_model_input(img[None])),) + tuple(torch.from_numpy(p[None]) for p in parts)


def task_term(model, task, images, t_xyxy, t_cls, extra=None):
    """The task branch's own loss on train-mode outputs (running statistics
    restored after)."""
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    with torch.no_grad():
        out = model.train()(images.permute(0, 3, 1, 2))
        valid = (t_cls >= 0).float()
        value = {"detect": lambda: ttrain.detection_loss(out, t_xyxy, t_cls, model.num_classes),
                 "obb": lambda: ttrain.obb_angle_loss(out, t_xyxy, extra, valid),
                 "pose": lambda: ttrain.pose_kpt_loss(out, t_xyxy, extra, valid),
                 "segment": lambda: ttrain.segment_loss(out, t_xyxy, extra, valid, S)}[task]()
    model.load_state_dict(stats, strict=False)
    return float(value)


@pytest.mark.parametrize("task", ["detect", "obb", "pose", "segment"])
def test_train_step_learns(task):
    kw = {"num_keypoints": 5} if task == "pose" else {}
    model = create_model(2 if task == "detect" else 1, "p", task, seed=0, **kw)
    st = ttrain.create_train_state(model, learning_rate=3e-3)
    step = ttrain.make_train_step(st)
    batch = fixed_scene(task)
    before = task_term(model, task, *batch)
    losses = [float(step(*batch)) for _ in range(25)]
    after = task_term(model, task, *batch)
    assert np.isfinite(losses).all() and np.isfinite(after)
    assert after < before, (before, after)
    assert losses[-1] < losses[0], losses


def test_classify_train_step_learns():
    model = create_model(4, "p", "classify", seed=0)
    step = ttrain.make_train_step(ttrain.create_train_state(model, learning_rate=3e-3))
    images = torch.from_numpy(np.stack([np.full((S, S, 3), v, np.float32) for v in (0.1, 0.4, 0.7, 0.9)]))
    labels = torch.arange(4)
    losses = [float(step(images, labels)) for _ in range(20)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses[:3] + losses[-3:]


def test_train_step_entry_on_the_cpu():
    loss = train_step_entry("cpu")
    assert np.isfinite(loss)
