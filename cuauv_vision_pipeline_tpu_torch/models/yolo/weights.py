"""Checkpoint I/O for the port's YOLO (all five tasks).

Two formats, as the JAX package reads and writes them:

* flax ``.msgpack`` checkpoints with a JSON sidecar (task, size, classes,
  serving resolution). Flax's format is read and written by a small
  pure-Python msgpack reader (:func:`msgpack_restore`) and writer
  (:func:`msgpack_serialize`) of the subset flax uses, since the card's
  machine need not have the ``msgpack`` package; the flax tree is carried
  onto the torch module by :func:`params_from_flax` and back by
  :func:`params_to_flax` (:func:`save_checkpoint`, what the trainer writes).
* ultralytics ``.pt`` weights: the torch state dict already uses the
  module's names (model.py), so import is a name-checked copy
  (:func:`map_ultralytics_state`) with the JAX package's report line and
  strictness; :func:`export_ultralytics_state` writes those names.

Layer correspondence (ultralytics yolov8*.yaml index -> flax module), the
port's copy of ``cuauv_vision_pipeline_tpu.models.yolo.weights``' table:

    0..9   backbone Conv/C2f/SPPF       -> ConvBnSilu_0..4, C2f_0..3, SPPF_0
    12,15  neck top-down C2f            -> C2f_4, C2f_5
    16,19  neck bottom-up downsamples   -> ConvBnSilu_5, ConvBnSilu_6
    18,21  neck bottom-up C2f           -> C2f_6, C2f_7
    22     Detect/OBB/Pose/Segment head -> {box,cls,ang,kpt,mask}_{conv1,conv2,out}_{s}
           (+ Segment's model.22.proto.{cv1,upsample,cv2,cv3} -> proto/*)
    9      (classify) Classify          -> classify_conv, classify_linear
           (yolov8-cls keeps backbone indices 0..8 and has no neck)

Within a Conv module: ``.conv.weight`` (OIHW) <- ``Conv_0/kernel`` (HWIO),
``.bn.{weight,bias,running_mean,running_var}`` <-
``BatchNorm_0/{scale,bias,mean,var}``. Proto's ``upsample``
(``ConvTranspose2d``, IOHW) <- flax ``ConvTranspose`` HWIO with the spatial
axes flipped (flax's ``conv_transpose`` does not flip the kernel, torch's
does); the classify ``linear`` (out, in) <- flax ``Dense`` (in, out).
"""

from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .model import TASKS, YOLO, create_model

_BACKBONE_IDX = {
    "ConvBnSilu_0": 0, "ConvBnSilu_1": 1, "C2f_0": 2, "ConvBnSilu_2": 3, "C2f_1": 4,
    "ConvBnSilu_3": 5, "C2f_2": 6, "ConvBnSilu_4": 7, "C2f_3": 8, "SPPF_0": 9,
    "C2f_4": 12, "C2f_5": 15, "ConvBnSilu_5": 16, "C2f_6": 18, "ConvBnSilu_6": 19,
    "C2f_7": 21,
}
_HEAD_IDX = 22
_WIDTH_TO_SIZE = {8: "p", 16: "n", 32: "s", 48: "m", 64: "l", 80: "x"}


# ---------------------------------------------------------------------------
# flax's msgpack format
# ---------------------------------------------------------------------------


class _Reader:
    """msgpack decoder for the subset flax writes: maps, arrays, str, bin,
    ints, floats, nil/bool, and ext 1 (ndarray), whose payload is itself a
    msgpack ``(shape, dtype name, C-order bytes)``."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {  # code -> (length format, kind)
            0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
            0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
            0xDC: (">H", "array"), 0xDD: (">I", "array"),
            0xDE: (">H", "map"), 0xDF: (">I", "map"),
            0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
        }
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} is not one flax writes")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code != 1:
            raise ValueError(f"msgpack ext type {code} is not flax's ndarray")
        shape, dtype, raw = _Reader(payload).read()
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def msgpack_restore(data: bytes) -> Any:
    """The tree flax's ``serialization.msgpack_restore`` gives for ``data``
    (nested dicts of numpy arrays)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack tree")
    _reject_chunked(tree)
    return tree


def _reject_chunked(tree: Any) -> None:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("chunked arrays (over 1 GiB) are not supported")
        for v in tree.values():
            _reject_chunked(v)


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes: Tuple[int, int, int]) -> None:
    """A msgpack header: ``fix | n`` while n <= fix_max (fix 0 = none),
    else the 8-, 16- or 32-bit length form of ``codes`` (0 = none)."""
    if fix and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack item of length {n} is too long")


def _pack(obj: Any, out: bytearray) -> None:
    """Append ``obj``'s msgpack encoding, as ``msgpack.packb`` writes it for
    the subset flax uses: maps (keys sorted, as flax's tree map orders
    them), str, bin, sequences, non-negative ints and ndarrays as ext 1."""
    if isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for key in sorted(obj):
            _pack(key, out)
            _pack(obj[key], out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), 0, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, int) and 0 <= obj < 1 << 64:
        if obj <= 0x7F:
            out.append(obj)
        else:
            code, fmt = next(c for c in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q"))
                             if obj < 1 << (8 * struct.calcsize(c[1])))
            out.append(code)
            out += struct.pack(fmt, obj)
    elif isinstance(obj, np.ndarray):
        # flax's ndarray ext: msgpack of (shape, dtype name, C-order bytes)
        payload = bytearray()
        _pack((tuple(int(d) for d in obj.shape), obj.dtype.name, obj.tobytes("C")), payload)
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + n.bit_length() - 1)
        else:
            _pack_len(out, n, 0, 0, (0xC7, 0xC8, 0xC9))
        out.append(1)
        out += payload
    else:
        raise TypeError(f"cannot write {type(obj).__name__} in flax's msgpack subset")


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes flax's ``serialization.msgpack_serialize`` writes for a
    tree of dicts and numpy arrays (arrays under 1 GiB)."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# flax tree -> ultralytics names
# ---------------------------------------------------------------------------


def _module_pairs(params: Dict, task: str) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(torch module prefix, flax module path, kind) for every mapped module;
    kind is 'convbn' (Conv+BN), 'conv' (plain 1x1 head conv with bias),
    'convT' (Proto's ConvTranspose) or 'dense' (the classify Linear)."""
    pairs: List[Tuple[str, Tuple[str, ...], str]] = []
    for flax_name, idx in _BACKBONE_IDX.items():
        if task == "classify" and idx > 8:
            continue
        tp = f"model.{idx}"
        if flax_name.startswith("ConvBnSilu"):
            pairs.append((tp, (flax_name,), "convbn"))
            continue
        pairs.append((f"{tp}.cv1", (flax_name, "ConvBnSilu_0"), "convbn"))
        pairs.append((f"{tp}.cv2", (flax_name, "ConvBnSilu_1"), "convbn"))
        j = 0
        while f"Bottleneck_{j}" in params.get(flax_name, {}):
            base = (flax_name, f"Bottleneck_{j}")
            pairs.append((f"{tp}.m.{j}.cv1", base + ("ConvBnSilu_0",), "convbn"))
            pairs.append((f"{tp}.m.{j}.cv2", base + ("ConvBnSilu_1",), "convbn"))
            j += 1
    if task == "classify":
        pairs.append(("model.9.conv", ("classify_conv",), "convbn"))
        pairs.append(("model.9.linear", ("classify_linear",), "dense"))
        return pairs
    extra = {"obb": "ang", "pose": "kpt", "segment": "mask"}.get(task)
    branches = [("cv2", "box"), ("cv3", "cls")] + ([("cv4", extra)] if extra else [])
    for s in range(3):
        for tb, fb in branches:
            hp = f"model.{_HEAD_IDX}.{tb}.{s}"
            pairs.append((f"{hp}.0", (f"{fb}_conv1_{s}",), "convbn"))
            pairs.append((f"{hp}.1", (f"{fb}_conv2_{s}",), "convbn"))
            pairs.append((f"{hp}.2", (f"{fb}_out_{s}",), "conv"))
    if task == "segment":
        pp = f"model.{_HEAD_IDX}.proto"
        pairs.append((f"{pp}.cv1", ("proto", "ConvBnSilu_0"), "convbn"))
        pairs.append((f"{pp}.upsample", ("proto", "up"), "convT"))
        pairs.append((f"{pp}.cv2", ("proto", "ConvBnSilu_1"), "convbn"))
        pairs.append((f"{pp}.cv3", ("proto", "ConvBnSilu_2"), "convbn"))
    return pairs


def _tensor_entries(torch_prefix: str, flax_path: Tuple[str, ...], kind: str):
    """(torch key, flax (collection, *path, leaf), layout) triples; layout is
    None (as is), "conv" (HWIO -> OIHW), "convT" (HWIO -> IOHW, spatially
    flipped) or "dense" (transposed)."""
    if kind == "convbn":
        bn = flax_path + ("BatchNorm_0",)
        return [
            (f"{torch_prefix}.conv.weight", ("params",) + flax_path + ("Conv_0", "kernel"), "conv"),
            (f"{torch_prefix}.bn.weight", ("params",) + bn + ("scale",), None),
            (f"{torch_prefix}.bn.bias", ("params",) + bn + ("bias",), None),
            (f"{torch_prefix}.bn.running_mean", ("batch_stats",) + bn + ("mean",), None),
            (f"{torch_prefix}.bn.running_var", ("batch_stats",) + bn + ("var",), None),
        ]
    return [
        (f"{torch_prefix}.weight", ("params",) + flax_path + ("kernel",), kind),
        (f"{torch_prefix}.bias", ("params",) + flax_path + ("bias",), None),
    ]


def _to_torch_layout(arr: np.ndarray, layout) -> np.ndarray:
    if layout == "conv":
        return np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
    if layout == "convT":
        return np.transpose(np.flip(arr, axis=(0, 1)), (2, 3, 0, 1))  # HWIO -> IOHW, flipped
    if layout == "dense":
        return arr.T  # (in, out) -> (out, in)
    return arr


def params_from_flax(variables: Dict, task: str) -> Dict[str, torch.Tensor]:
    """A flax YOLO variable tree (``{"params", "batch_stats"}`` of numpy
    arrays) as a state dict of the port's :class:`YOLO`: conv kernels HWIO ->
    OIHW, the ConvTranspose kernel HWIO -> IOHW flipped, the Dense kernel
    transposed, BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
    running_var. Raises KeyError on a missing tensor."""
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r} (tasks: {TASKS})")
    state: Dict[str, torch.Tensor] = {}
    for tp, fp, kind in _module_pairs(variables["params"], task):
        for tkey, fkey, layout in _tensor_entries(tp, fp, kind):
            node = variables
            for part in fkey:
                node = node[part]
            arr = _to_torch_layout(np.asarray(node, np.float32), layout)
            state[tkey] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return state


def _to_flax_layout(arr: np.ndarray, layout) -> np.ndarray:
    """The inverse of :func:`_to_torch_layout`."""
    if layout == "conv":
        return np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
    if layout == "convT":
        return np.flip(np.transpose(arr, (2, 3, 0, 1)), axis=(0, 1))  # IOHW -> HWIO, flipped
    if layout == "dense":
        return arr.T
    return arr


def _flax_skeleton(model: YOLO) -> Dict:
    """The flax params' C2f nodes with their ``Bottleneck_j`` children, as
    :func:`_module_pairs` reads them, from the torch module's blocks."""
    return {name: {f"Bottleneck_{j}": {} for j in range(len(model.model[str(idx)].m))}
            for name, idx in _BACKBONE_IDX.items()
            if name.startswith("C2f") and str(idx) in model.model}


def params_to_flax(model: YOLO, tensors: Dict[str, torch.Tensor] = None) -> Dict:
    """The inverse of :func:`params_from_flax`: ``model``'s state dict (or
    ``tensors``, a dict under the same names, e.g. gradients; names it
    lacks are left out) as a flax variable tree ``{"params",
    "batch_stats"}`` of numpy arrays (the tensors' dtype) in flax's
    layouts."""
    tensors = model.state_dict() if tensors is None else tensors
    tree: Dict = {}
    for tp, fp, kind in _module_pairs(_flax_skeleton(model), model.task):
        for tkey, fkey, layout in _tensor_entries(tp, fp, kind):
            if tkey not in tensors:
                continue
            node = tree
            for part in fkey[:-1]:
                node = node.setdefault(part, {})
            arr = tensors[tkey].detach().cpu().numpy()
            node[fkey[-1]] = np.array(_to_flax_layout(arr, layout), order="C")  # a copy
    return tree


def export_ultralytics_state(model: YOLO) -> Dict[str, np.ndarray]:
    """``model``'s tensors under ultralytics v8 names (OIHW convs), as
    float32 numpy arrays: the JAX package's ``export_ultralytics_state``
    for the same weights."""
    return {key: value.detach().to("cpu", torch.float32).numpy().copy()
            for key, value in model.state_dict().items()}


def map_ultralytics_state(state: Dict[str, Any], model: YOLO) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Name-driven import of an ultralytics v8 state dict (tensors or numpy
    arrays) onto ``model``: (``model``'s state dict with every name found at
    its shape replaced, report of mapped / missing / shape-mismatched
    tensors). Keys the model lacks (the frozen DFL conv) are ignored."""
    own = model.state_dict()
    report = {"mapped": 0, "missing": 0, "mismatched": 0}
    for key, want in own.items():
        if key not in state:
            report["missing"] += 1
            continue
        got = state[key]
        got = got.float() if isinstance(got, torch.Tensor) else torch.from_numpy(np.array(got, np.float32))
        if got.shape != want.shape:
            report["mismatched"] += 1
            continue
        own[key] = got
        report["mapped"] += 1
    return own, report


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def save_checkpoint(path: str, model: YOLO, extra: Dict) -> None:
    """Write ``model`` as a flax ``.msgpack`` (:func:`params_to_flax`,
    :func:`msgpack_serialize`) with its ``.json`` sidecar: task, size,
    num_classes, num_keypoints, num_masks and ``extra``. The sidecar keeps
    ``image_size`` only where ``extra`` gives one, so the checkpoint serves
    at its trained resolution."""
    with open(path, "wb") as fh:
        fh.write(msgpack_serialize(params_to_flax(model)))
    meta = {"task": model.task, "size": model.size, "num_classes": model.num_classes,
            "num_keypoints": model.num_keypoints, "num_masks": model.num_masks, **extra}
    if meta.get("image_size") is None:
        meta.pop("image_size", None)
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh)


def load_checkpoint(path: str) -> Tuple[YOLO, Dict]:
    """(float32 model on the CPU with the checkpoint's weights, meta)."""
    if path.endswith(".pt"):
        return _load_ultralytics(path)
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as fh:
            meta = json.load(fh)
    task = meta.get("task", "detect")
    model = YOLO(meta.get("num_classes", 80), meta.get("size", "n"), task,
                 num_keypoints=meta.get("num_keypoints", 17), num_masks=meta.get("num_masks", 32))
    try:
        with open(path, "rb") as fh:
            variables = msgpack_restore(fh.read())
        model.load_state_dict(params_from_flax(variables, task))
    except Exception as exc:
        raise RuntimeError(f"failed to read YOLO weight file '{path}': {exc}") from exc
    return model.eval(), meta


def _load_ultralytics(path: str) -> Tuple[YOLO, Dict]:
    """Import an ultralytics .pt checkpoint (any of the five tasks)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except Exception as exc:
        raise RuntimeError(f"failed to read YOLO weight file '{path}': {exc}") from exc
    torch_model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    names = getattr(torch_model, "names", None) or (
        ckpt.get("names") if isinstance(ckpt, dict) else None
    )
    if isinstance(names, dict):
        names = [names[k] for k in sorted(names)]
    # task: a .task attribute, a top-level "task" key, train_args["task"],
    # else the head's structure below
    task = getattr(torch_model, "task", None)
    if not task and isinstance(ckpt, dict):
        task = ckpt.get("task")
        if not task:
            targs = ckpt.get("train_args")
            task = targs.get("task") if isinstance(targs, dict) else getattr(targs, "task", None)
    raw = torch_model.state_dict() if hasattr(torch_model, "state_dict") else torch_model
    state = {k: v.float() for k, v in raw.items() if isinstance(v, torch.Tensor)}

    stem = state.get("model.0.conv.weight")
    if stem is None:
        raise RuntimeError(
            f"'{path}' has no 'model.0.conv.weight' — not an ultralytics v8 "
            f"state dict (keys start: {sorted(state)[:5]})"
        )
    if stem.shape[0] not in _WIDTH_TO_SIZE:
        raise RuntimeError(
            f"'{path}' stem width {stem.shape[0]} matches no known yolov8 size "
            f"(known widths: {sorted(_WIDTH_TO_SIZE)}); refusing to build a mismatched model"
        )
    size = _WIDTH_TO_SIZE[stem.shape[0]]
    cls_bias = state.get(f"model.{_HEAD_IDX}.cv3.0.2.bias")
    num_classes = len(names) if names else (cls_bias.shape[0] if cls_bias is not None else 80)
    # the head's structure names the task when nothing declared it: a Proto
    # means segment (its 32-wide cv4 would read as pose), a classify Linear
    # classify, OBB's angle branch ends in 1 channel, pose's in 3*nk
    cv4_bias = state.get(f"model.{_HEAD_IDX}.cv4.0.2.bias")
    has_proto = f"model.{_HEAD_IDX}.proto.cv1.conv.weight" in state
    linear_bias = state.get("model.9.linear.bias")
    if not task:
        if linear_bias is not None:
            task = "classify"
        elif has_proto:
            task = "segment"
        elif cv4_bias is None:
            task = "detect"
        else:
            task = "obb" if cv4_bias.shape[0] == 1 else "pose"
    if task not in TASKS:
        raise RuntimeError(f"'{path}' is a {task!r} checkpoint; the port serves {TASKS}")
    if task == "classify" and not names and linear_bias is not None:
        num_classes = int(linear_bias.shape[0])  # no detect head to read
    # pose and segment checkpoints carry nk and nm in the cv4 branch width
    num_keypoints = int(cv4_bias.shape[0]) // 3 if task == "pose" and cv4_bias is not None else 17
    num_masks = int(cv4_bias.shape[0]) if task == "segment" and cv4_bias is not None else 32

    model = create_model(num_classes, size, task, num_keypoints=num_keypoints, num_masks=num_masks)
    own, report = map_ultralytics_state(state, model)
    print(
        f"[yolo] .pt import ({task}/{size}): {report['mapped']} tensors mapped, "
        f"{report['missing']} missing, {report['mismatched']} shape-mismatched"
    )
    if report["mapped"] == 0:
        raise RuntimeError(
            f"'{path}': no tensors mapped — checkpoint layout does not match yolov8 {task}/{size}"
        )
    if report["missing"] or report["mismatched"]:
        warnings.warn(
            f"'{path}': partial .pt import — {report['missing']} expected tensors "
            f"missing, {report['mismatched']} shape-mismatched (mapped "
            f"{report['mapped']}); the unmapped layers keep their random init and "
            f"the model WILL mispredict",
            RuntimeWarning,
            stacklevel=2,
        )
    model.load_state_dict(own)
    meta = {"task": task, "size": size, "names": names or []}
    return model, meta
