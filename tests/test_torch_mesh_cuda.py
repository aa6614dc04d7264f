"""The mesh on the card (``parallel/mesh.py``, ``entry.dryrun_multichip``).

* ``dryrun_multichip(1, backend="nccl")``: one rank on cuda:0 passes the
  JAX dry run's assertions and launches ``fused_morph``, ``label_cuda``,
  ``spacing_select`` and ``nms_fixed``; its camera and merged list equal
  the one-card ``chain_one`` and ``cross_camera_nms`` in this process.
* Two ranks sharing cuda:0 over ``gloo`` (dp 1 x tp 2): the train step
  against the one-process card step on the global batch (TF32 off): loss
  within rtol 1e-5, every gradient within 2e-4 of its norm (chip_smoke's
  ``TRAIN_LOSS_RTOL``/``TRAIN_GRAD_TOL``); each rank's camera and the
  merged list exactly as the one-card forms compute them.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh_cuda.py
"""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch import entry
from cuauv_vision_pipeline_tpu_torch.core.device import full_f32
from cuauv_vision_pipeline_tpu_torch.models.yolo.model import create_model
from cuauv_vision_pipeline_tpu_torch.models.yolo.train import create_train_state, make_train_step
from cuauv_vision_pipeline_tpu_torch.parallel.crosscam import cross_camera_nms
from cuauv_vision_pipeline_tpu_torch.parallel.fanout import chain_one
from cuauv_vision_pipeline_tpu_torch.parallel.mesh import gather_params

pytestmark = pytest.mark.cuda
LOSS_RTOL, GRAD_TOL = 1e-5, 2e-4
PATH_KERNELS = ("fused_morph", "label_cuda", "spacing_select", "nms_fixed")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def check_cameras_and_merge(result, dev):
    data = result["data"]
    for cam, r in enumerate(result["ranks"]):
        want = chain_one(torch.from_numpy(data["frames"][cam]).to(dev), 140, 255)
        for key, value in want.items():
            np.testing.assert_array_equal(r["fan"][key], value.cpu().numpy(), err_msg=key)
        assert all(r["launches"][k] > 0 for k in PATH_KERNELS), r["launches"]
    merged = cross_camera_nms(torch.from_numpy(data["dets"]).to(dev), max_det=entry.DRYRUN_MAX_DET)
    for r in result["ranks"]:
        np.testing.assert_array_equal(r["merged"], merged.cpu().numpy())


def test_dryrun_one_rank_on_nccl(dev):
    result = entry.dryrun_multichip(1, backend="nccl")
    assert (result["dp"], result["tp"]) == (1, 1) and np.isfinite(result["loss"])
    check_cameras_and_merge(result, dev)


def test_two_gloo_ranks_on_one_card_equal_the_one_process_step(dev):
    result = entry.dryrun_multichip(2, backend="gloo", device="cuda:0")
    assert (result["dp"], result["tp"]) == (1, 2)
    ranks, data = result["ranks"], result["data"]
    model = create_model(entry.DRYRUN_CLASSES, "n", "detect").to(dev)
    step = make_train_step(create_train_state(model))
    with full_f32():
        loss = float(step(*(torch.from_numpy(data[k]).to(dev) for k in ("images", "t_xyxy", "t_cls"))))
    np.testing.assert_allclose(result["loss"], loss, rtol=LOSS_RTOL)
    grads = gather_params([r["grads"] for r in ranks], np.arange(2).reshape(1, 2), ranks[0]["shardings"])
    for name, p in model.named_parameters():
        want = p.grad.cpu()
        err = (grads[name] - want).abs().max().item()
        assert err <= GRAD_TOL * max(want.norm().item(), 1e-30), (name, err)
    check_cameras_and_merge(result, dev)
