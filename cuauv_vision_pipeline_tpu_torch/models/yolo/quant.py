"""The quantized serving modes of the port's YOLO: weight-only ``int8`` and
``w8a8`` (int8 weights and activations).

Port of the JAX package's ``predictor.quantize_weights_int8`` and
``predictor._w8a8_conv_interceptor``:

* ``int8``: every 4-D float kernel (the convs, the heads' output convs and
  Proto's ConvTranspose) is stored as int8 with a symmetric per-output-
  channel scale ``max|w| / 127`` (0 -> 1), computed on the unfolded float32
  kernel, values ``rint(w / s)`` clipped to +-127. The forward's weights are
  those values dequantized to the serving dtype (bf16, or float32 in the
  exact mode); the BatchNorms are folded into them after that, as in the
  unquantized mode. The store is computed once, kept on the host, and the
  model is refolded from it at every placement. The mode reproduces the
  JAX package's numbers; it saves no device memory, as the device holds
  the dequantized weights.
* ``w8a8``: every ``nn.Conv2d`` (the Conv-BN-SiLU convs, the heads' output
  convs, the classify conv; not Proto's ConvTranspose, not the classify
  Linear, as JAX intercepts ``nn.Conv`` only) runs as an int8 x int8 ->
  int32 convolution: weight scales per output channel from the float32
  kernel, a dynamic per-tensor activation scale ``max(max|x| / 127,
  1e-8)``, round half to even, clip to +-127; then ``acc * s_x * s_w (+
  bias)`` cast to the activation dtype, the BatchNorm as a per-channel
  affine in that dtype, and SiLU. The folded weights of ``fuse_`` cannot
  serve this mode.

The int8 convolution: on the CPU its plain version, a float64 convolution
of the int8 values cast to int32 (exact: |acc| <= 127^2 * K, far below
2^53); on the card im2col + ``torch._int_mm`` (cuBLASLt int8 GEMM with int32
accumulation; a library call, as JAX's int8 conv is an XLA convolution, not
a Pallas kernel). ``_int_mm`` wants more than 16 rows and K, N multiples of
8, so K and N are zero-padded (layer 0's K = 27, the angle head's N = 1) and
a shape it still rejects raises: there is no float fallback.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .model import BN_EPS, ConvBnSilu, PlainConv

MODES = ("int8", "w8a8")


def resolve_mode(quantize: Optional[str]) -> Optional[str]:
    """The serving mode: ``quantize`` if given, else ``CUAUV_YOLO_QUANT``,
    else ``"int8"`` when ``CUAUV_YOLO_INT8=1``; ``None`` is unquantized.
    Raises ValueError on any other mode."""
    if quantize is None:
        quantize = os.environ.get("CUAUV_YOLO_QUANT", "") or (
            "int8" if os.environ.get("CUAUV_YOLO_INT8", "") == "1" else None)
    if quantize not in (None,) + MODES:
        raise ValueError(f"unsupported quantize mode {quantize!r}")
    return quantize


def quantize_weight(w: torch.Tensor, out_dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scales ``[out]``) of a float kernel, symmetric
    per output channel (dim ``out_dim``)."""
    w = w.float()
    dims = tuple(d for d in range(w.ndim) if d != out_dim)
    s = w.abs().amax(dim=dims) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    shape = [1] * w.ndim
    shape[out_dim] = -1
    q = torch.clamp(torch.round(w / s.view(shape)), -127, 127).to(torch.int8)
    return q, s


def _kernels(model: nn.Module):
    """(parameter name, module, output-channel dim) of every 4-D kernel."""
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            # ConvTranspose2d kernels are [in, out, kh, kw]
            yield f"{name}.weight", mod, int(isinstance(mod, nn.ConvTranspose2d))


def quantize_weights_int8(model: nn.Module) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The weight-only int8 store: parameter name -> (int8 kernel, scales)."""
    return {name: quantize_weight(mod.weight.detach(), dim) for name, mod, dim in _kernels(model)}


@torch.no_grad()
def dequantize_int8_(model: nn.Module, store: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                     dtype: torch.dtype) -> None:
    """Set every kernel to its int8 values times their scales, both in
    ``dtype`` (the product rounded there, on the store's device), held in
    float32 on the model's device for the fold."""
    for name, mod, dim in _kernels(model):
        q, s = store[name]
        shape = [1] * q.ndim
        shape[dim] = -1
        mod.weight.copy_((q.to(dtype) * s.to(dtype).view(shape)).float())


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """int8 ``[B, C, H, W]`` (*) int8 ``[O, C, k, k]`` -> int32 ``[B, O, Ho,
    Wo]``: a float64 convolution of the integer values (exact), cast."""
    acc = F.conv2d(xq.double(), wq.double(), None, stride, padding)
    return acc.round().to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_gemm_conv(xq: torch.Tensor, wmat: torch.Tensor, kernel: int, stride: int, padding: int,
                   out_channels: int) -> torch.Tensor:
    """The int8 convolution as im2col + ``torch._int_mm`` on NHWC memory:
    ``wmat`` is the kernel as ``[N, K]`` (N = output channels, K = kh * kw *
    C in (kh, kw, C) order), both zero-padded to multiples of 8. Returns
    int32 ``[B, O, Ho, Wo]`` (channels_last)."""
    x = xq.permute(0, 2, 3, 1)  # NHWC (a view of channels_last memory)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    b, h, w, c = x.shape
    ho, wo = (h - kernel) // stride + 1, (w - kernel) // stride + 1
    if kernel == 1 and stride == 1:
        a = x.reshape(b * h * w, c)
    else:
        a = (x.unfold(1, kernel, stride).unfold(2, kernel, stride)  # [B, Ho, Wo, C, kh, kw]
             .permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, kernel * kernel * c))
    m, k = a.shape
    rows = max(m, 17)  # _int_mm wants more than 16 rows
    if (rows, wmat.shape[1]) != (m, k):
        a = F.pad(a, (0, wmat.shape[1] - k, 0, rows - m))
    acc = torch._int_mm(a.contiguous(), wmat.t())
    return acc[:m, :out_channels].reshape(b, ho, wo, out_channels).permute(0, 3, 1, 2)


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale) of an activation: one dynamic scale for
    the whole tensor, ``max(max|x| / 127, 1e-8)``, round half to even,
    clip to +-127."""
    xf = x.float()
    s_x = torch.clamp_min(xf.abs().amax() / 127.0, 1e-8)
    return torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8), s_x


class Int8Conv:
    """One ``nn.Conv2d`` in the w8a8 mode (call it on activations in the
    serving dtype): int8 weights with float32 per-output-channel scales
    from the float32 kernel, the bias rounded to ``dtype`` as the JAX
    package's bf16 parameters are."""

    def __init__(self, conv: nn.Conv2d, dtype: torch.dtype):
        self.wq, self.s_w = quantize_weight(conv.weight.detach(), 0)
        self.bias = None if conv.bias is None else conv.bias.detach().to(dtype).float()
        self.kernel, self.stride, self.padding = conv.kernel_size[0], conv.stride[0], conv.padding[0]
        o, c = self.wq.shape[:2]
        wmat = self.wq.permute(0, 2, 3, 1).reshape(o, -1)
        self.wmat = F.pad(wmat, (0, _round_up(wmat.shape[1], 8) - wmat.shape[1],
                                 0, _round_up(o, 8) - o)).contiguous()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xq, s_x = quantize_activation(x)
        acc = int8_conv(xq, self)
        out = acc.float() * (s_x * self.s_w)[:, None, None]
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out.to(x.dtype)


def int8_conv(xq: torch.Tensor, conv: Int8Conv) -> torch.Tensor:
    """``conv``'s int8 convolution of ``xq``: ``_int_mm`` on CUDA tensors,
    the plain float64 version on CPU ones."""
    if xq.is_cuda:
        return int8_gemm_conv(xq, conv.wmat, conv.kernel, conv.stride, conv.padding, conv.wq.shape[0])
    return int8_conv_plain(xq, conv.wq, conv.stride, conv.padding)


@torch.no_grad()
def w8a8_(model: nn.Module, dtype: torch.dtype) -> None:
    """Put ``model`` (on its device) into the w8a8 mode for activations in
    ``dtype``: every conv through :class:`Int8Conv`, the BatchNorms as
    affines in ``dtype`` ((x - mean) * (rsqrt(var + eps) * scale) + shift,
    flax's order), Proto's ConvTranspose and the classify Linear cast."""
    for mod in model.modules():
        if isinstance(mod, ConvBnSilu):
            bn = mod.bn
            mul = torch.rsqrt(bn.running_var.to(dtype) + BN_EPS) * bn.weight.to(dtype)
            mod.qconv, mod.fused = Int8Conv(mod.conv, dtype), None
            mod.bn_affine = (bn.running_mean.to(dtype)[:, None, None], mul[:, None, None],
                             bn.bias.to(dtype)[:, None, None])
        elif isinstance(mod, PlainConv):
            mod.qconv = Int8Conv(mod, dtype)
        elif isinstance(mod, nn.ConvTranspose2d):
            mod.to(dtype=dtype, memory_format=torch.channels_last)
        elif isinstance(mod, nn.Linear):
            mod.to(dtype=dtype)
