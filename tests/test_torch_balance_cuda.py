"""BASELINE config 4's device work on the card, against the same calls on the
CPU (held against the JAX package by tests/test_torch_balance.py and
tests/test_torch_correction_modules.py):

* ``ops/balance.balance`` at 720p and 1080p, the default config and each
  non-default one (RGB contrast, HSV contrast, adaptive taper, blocks 4x3):
  within 1 count of the CPU, except pixels whose hue lies within 1e-5 rad
  of an HSI sector edge (at most 1e-4 of the frame); and no host sync.
* the preprocessor's stage stack (every stage but balance and the noise)
  at 720p, exact;
* ``gaussian_blur`` on u8 bit-exact for ksize 3-9;
* the tile means unchanged with TF32 forced on: the segment sum takes no
  TF32 path.

Needs a CUDA card and skips without one. It imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_balance_cuda.py
"""

import copy
import math

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.modules import preprocessor as P
from cuauv_vision_pipeline_tpu_torch.ops import balance as B
from cuauv_vision_pipeline_tpu_torch.ops import transform as X

pytestmark = pytest.mark.cuda

CONFIGS = {
    "default": B.BalanceConfig(),
    "rgb_contrast": B.BalanceConfig(rgb_contrast_correct=True),
    "hsv_contrast": B.BalanceConfig(hsv_contrast_correct=True),
    "adaptive": B.BalanceConfig(adaptive_cast_correction=True),
    "blocks_4x3": B.BalanceConfig(horizontal_blocks=4, vertical_blocks=3),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _near_edge(img, cfg):
    """Pixels whose HSI hue (before the stretch) lies within 1e-5 rad of a
    sector edge, on the CPU."""
    if not cfg.hsi_contrast_correct:
        return np.zeros(img.shape[:2], bool)
    h = B._rgb_to_hsi(*B.corrected_rgb(torch.from_numpy(img), cfg))[0].double().numpy()
    h = np.where(h < 0, h + 2 * math.pi, h)
    third = 2 * math.pi / 3
    return np.abs(h - np.round(h / third) * third) < 1e-5


@pytest.mark.parametrize("hw", [(720, 1280), (1080, 1920)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_balance_card_against_cpu(dev, name, hw):
    cfg = CONFIGS[name]
    img = buoy_frame(hw, 0.7)
    got = B.balance(torch.from_numpy(img).to(dev), cfg).cpu().numpy().astype(int)
    want = B.balance(torch.from_numpy(img), cfg).numpy().astype(int)
    bad = np.abs(got - want).max(-1) > 1
    assert not (bad & ~_near_edge(img, cfg)).any()
    assert bad.mean() <= 1e-4


def test_balance_never_syncs_the_host(dev):
    img = torch.from_numpy(buoy_frame((720, 1280), 0.7)).to(dev)
    for cfg in CONFIGS.values():
        B.balance(img, cfg)  # first-use costs outside the checked call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for cfg in CONFIGS.values():
            B.balance(img, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _stack(device):
    """Every stage but balance (held on its own above) and the noise
    (another generator on each device)."""
    module = P.Preprocessor(["forward"], copy.deepcopy(P.module_tuners), argv=["--device", str(device)], seed=0)
    values = dict(channel_split=8, grayscale=False, bias_r=40, bias_g=-30, bias_b=20,
                  contrast=1.37, brightness=-20, blur_kernel=7, erode_kernel=2, dilate_kernel=3,
                  rotate_deg=23.5, resize_factor=0.63, translate_x=7, translate_y=-4)
    for k, v in values.items():
        module._module_manager._tuner_sources[k]._current_value = v
    return module


def test_preprocessor_stack_card_against_cpu(dev):
    img = buoy_frame((720, 1280), 0.7)
    got = _stack(dev).stages(torch.from_numpy(img).to(dev)).cpu().numpy()
    want = _stack("cpu").stages(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (453, 806, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_gaussian_blur_u8_bit_exact_on_the_card(dev, ksize):
    img = buoy_frame((720, 1280), 0.7)
    got = X.gaussian_blur(torch.from_numpy(img).to(dev), ksize).cpu()
    assert torch.equal(got, X.gaussian_blur(torch.from_numpy(img), ksize))


def test_block_means_take_no_tf32_path(dev):
    ch = torch.from_numpy(buoy_frame((1080, 1920), 0.7)[..., 1].astype(np.float32))
    want = B._block_means(ch, 4, 3)
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = B._block_means(ch.to(dev), 4, 3).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm
    assert torch.equal(got, want)
