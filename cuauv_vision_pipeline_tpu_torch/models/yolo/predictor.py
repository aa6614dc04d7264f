"""High-level YOLO predictor: the ultralytics-YOLO-shaped entry point.

Port of ``cuauv_vision_pipeline_tpu.models.yolo.predictor`` (all five
tasks, and the int8 and w8a8 modes of ``quant.py``): construct from a weight
path (or task + class names), ``.task``, ``.to(device)``, and
``.track(image)`` returning objects whose ``.summary()`` yields the dicts
MAP_FN parses (classify: the top 5 classes). The preamble, conv stack,
decode and NMS run on the model's device (``cuda:0`` unless told otherwise);
tracking is host-side (tracker.py).

The letterbox is the matrix-product form (``preprocess_fused``), equal at
the u8 level to the JAX package's gather form at the serving sizes.

Precision: ``half_precision=True`` (serving) runs the conv stack in bf16 —
every BatchNorm folded into its conv in float32, the folded weights and the
head convs then cast to bf16, activations bf16 — and casts the head outputs
to float32 for decode. ``half_precision=False`` is the exact-f32 debugging
mode: the forward then runs with TF32 off for convolutions and matrix
products (Hopper's cuDNN takes TF32 for f32 convs by default). The
letterbox's matrix products are always full float32.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...core.device import full_f32, resolve_device
from . import quant
from .decode import decode, summarize
from .model import create_model, letterbox_params, preprocess_fused
from .tracker import ByteTracker
from .weights import load_checkpoint

DEFAULT_CLASS_NAMES = [
    "torpedo_board", "shark_hole", "saw_hole",
    "shark", "saw", "gate_behind",
    "pole_red", "pole_white",
    "bin_shark", "bin_saw", "bin",
    "spoon", "cup", "pink_basket", "yellow_basket",
]


class _Result:
    """Mimics ultralytics Results just enough for .summary()."""

    def __init__(self, summary: List[Dict]):
        self._summary = summary

    def summary(self) -> List[Dict]:
        return self._summary


class YoloModel:
    """YOLO with the call surface modules/yolo.py expects."""

    def __init__(
        self,
        weight_path: Optional[str] = None,
        task: str = "obb",
        class_names: Optional[Sequence[str]] = None,
        size: str = "n",
        image_size: Optional[int] = None,
        conf_thresh: float = 0.25,
        max_det: int = 32,
        half_precision: bool = True,
        quantize: Optional[str] = None,
        nms_pool: int = 512,
        device=None,
    ):
        """``device``: ``None`` is ``cuda:0`` (raises without CUDA), else as
        ``core.device.resolve_device`` reads it (``"cpu"``, ``N``, a
        ``torch.device``). With no weight file the model serves seeded random
        init (seed 0). ``quantize``: ``None``, ``"int8"`` (weight-only) or
        ``"w8a8"`` (quant.py); unset, ``CUAUV_YOLO_QUANT=int8|w8a8`` or
        ``CUAUV_YOLO_INT8=1`` choose it; any other mode raises ValueError.
        ``nms_pool`` bounds the NMS candidate set (exact while the
        above-``conf_thresh`` candidates fit it); ``CUAUV_YOLO_NMS_POOL``
        overrides it."""
        self.quantize = quant.resolve_mode(quantize)
        # None = serve at the checkpoint's embedded training resolution
        # (else 640); an explicit value always wins
        self.image_size = image_size if image_size is not None else 640
        self.half_precision = half_precision
        self.conf_thresh = conf_thresh
        self.max_det = max_det
        self.nms_pool = int(os.environ.get("CUAUV_YOLO_NMS_POOL", nms_pool))
        self._tracker = ByteTracker()

        if weight_path and os.path.exists(weight_path):
            self.model, meta = load_checkpoint(weight_path)
            self.task = meta.get("task", task)
            if image_size is None and meta.get("image_size"):
                self.image_size = int(meta["image_size"])
            # `or`: a .pt without embedded names stores []
            self.class_names = list(meta.get("names") or class_names or DEFAULT_CLASS_NAMES)
        else:
            if weight_path:
                warnings.warn(
                    f"YOLO weight '{weight_path}' not found — serving RANDOM-INIT "
                    f"weights (detections are noise). Fix the path / "
                    f"CUAUV_YOLO_WEIGHT for production.",
                    RuntimeWarning,
                    stacklevel=2,
                )
            self.class_names = list(class_names or DEFAULT_CLASS_NAMES)
            self.task = task
            self.model = create_model(len(self.class_names), size=size, task=task)
        # the weight-only int8 store, from the float32 weights, kept on the
        # host: only the weights dequantized from it go to the device
        self._int8 = quant.quantize_weights_int8(self.model) if self.quantize == "int8" else None
        self.to(resolve_device(device))

    def to(self, device) -> "YoloModel":
        """Place the model on ``device`` (a ``torch.device``, ``"cpu"``,
        ``"cuda:N"``) and refold its BatchNorms there for this precision
        (from the int8 store in that mode; w8a8 quantizes there instead)."""
        self.device = torch.device(device)
        self.dtype = torch.bfloat16 if self.half_precision else torch.float32
        self.model.to(self.device, memory_format=torch.channels_last)
        if self.quantize == "w8a8":
            quant.w8a8_(self.model, self.dtype)
            return self
        if self._int8 is not None:
            quant.dequantize_int8_(self.model, self._int8, self.dtype)
        self.model.fuse_(self.dtype)
        return self

    def _letterbox(self, images_u8: torch.Tensor) -> torch.Tensor:
        """[K, H, W, 3] u8 BGR on the device -> [K, S, S, 3] float32."""
        with torch.inference_mode(), full_f32():
            return preprocess_fused(images_u8, self.image_size)

    def _heads(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """The conv stack on letterboxed [K, S, S, 3] float32 -> the raw
        per-scale head maps (NHWC, float32; segment's ``proto`` and
        classify's ``logits`` are single tensors)."""
        with torch.inference_mode():
            # NHWC memory seen as NCHW: a channels_last tensor, no copy
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            with contextlib.nullcontext() if self.half_precision else full_f32():
                outputs = self.model(x)
            return {k: [o.float() for o in v] if isinstance(v, list) else v.float()
                    for k, v in outputs.items()}

    def _decode(self, outputs: Dict[str, List[torch.Tensor]]) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            if self.task == "classify":
                return {"probs": torch.softmax(outputs["logits"], -1)}
            return decode(outputs, self.image_size, reg_max=self.model.reg_max,
                          conf_thresh=self.conf_thresh, max_det=self.max_det,
                          nms_pool=self.nms_pool)

    def head_outputs(self, images_u8: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """[K, H, W, 3] u8 BGR on the device -> the raw per-scale head maps
        (NHWC, float32): letterbox and conv stack, before decode."""
        return self._heads(self._letterbox(images_u8))

    def head_outputs_multi(self, images) -> Dict[str, List[torch.Tensor]]:
        """N cameras' ``[H_i, W_i, 3]`` u8 BGR frames (numpy or tensors, any
        sizes) -> head maps with a leading camera axis: each frame
        letterboxed on its own, then ONE conv stack at batch N."""
        xs = torch.cat([self._letterbox(self._to_device(im)[None]) for im in images])
        return self._heads(xs)

    def _forward(self, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[K, H, W, 3] u8 BGR on the device -> decode dict, leaves [K, ...]."""
        return self._decode(self.head_outputs(images_u8))

    def _to_device(self, image) -> torch.Tensor:
        if isinstance(image, np.ndarray):
            image = torch.from_numpy(np.ascontiguousarray(image))
        return image.to(self.device)

    def device_decode(self, image) -> Dict[str, torch.Tensor]:
        """One ``[H, W, 3]`` u8 BGR frame (numpy or tensor) -> the
        fixed-shape decode dict of device tensors (``[max_det]`` leaves)."""
        out = self._forward(self._to_device(image)[None])
        return {k: v[0] for k, v in out.items()}

    def device_decode_batch(self, images) -> Dict[str, torch.Tensor]:
        """Same-camera batched forward: ``[K, H, W, 3]`` queue-drained frames
        (the shape a ``@device_fn(batch=K)`` dispatch carries) as ONE K-batch
        conv stack; every leaf of the decode dict gains a leading lane axis."""
        return self._forward(self._to_device(images))

    def device_decode_multi(self, images) -> Dict[str, torch.Tensor]:
        """Multi-camera batched forward: letterbox each camera's frame (sizes
        differ per camera), stack to ``[N, S, S, 3]``, run ONE conv stack at
        batch N and decode once, so the NMS kernel runs all N cameras in one
        launch. Every leaf of the decode dict has the camera axis in front;
        pass camera i's slice to :meth:`summarize_decoded` with that camera's
        own (h, w)."""
        return self._decode(self.head_outputs_multi(images))

    def summarize_decoded(self, decoded_np: Dict, orig_hw: Tuple[int, int]) -> List[Dict]:
        """Host half: undo the letterbox (orig = (model_coord - pad) /
        scale) and format ultralytics-style summary dicts; classify: the
        top 5 ``{name, class, confidence}`` (ultralytics' classification
        summary)."""
        if self.task == "classify":
            probs = np.asarray(decoded_np["probs"])
            return [{"name": self.class_names[i] if i < len(self.class_names) else str(int(i)),
                     "class": int(i), "confidence": float(probs[i])}
                    for i in np.argsort(probs)[::-1][:5]]
        h, w = orig_hw
        scale, left, top, _, _ = letterbox_params(h, w, self.image_size)
        return summarize(decoded_np, self.class_names, (1.0 / scale, 1.0 / scale), self.task,
                         pad=(left, top), clip_wh=(float(w), float(h)), image_size=self.image_size)

    def predict(self, image: np.ndarray) -> List[Dict]:
        decoded = {k: v.cpu().numpy() for k, v in self.device_decode(image).items()}
        return self.summarize_decoded(decoded, image.shape[:2])

    def track(self, image: np.ndarray, verbose: bool = False) -> List[_Result]:
        summary = self.predict(image)
        if self.task != "classify":  # whole-frame labels carry no boxes
            self._tracker.update(summary)
        return [_Result(summary)]

    def __call__(self, image: np.ndarray) -> List[_Result]:
        return [_Result(self.predict(image))]
