"""A (data, model) mesh of ranks on ``torch.distributed``.

Port of ``cuauv_vision_pipeline_tpu.parallel.mesh``. The JAX package lays
its devices out as a (data, model) grid and lets GSPMD insert the
collectives; here each device is a process (a rank), and the collectives
are explicit:

* ``data`` (dp) splits the frame batch: every rank of a data group holds the
  same parameters and its own slice of the batch (:func:`shard_batch`);
* ``model`` (tp) splits the output channels of the wide conv and dense
  kernels (:func:`param_shardings`, :func:`place`): each rank of a model
  group computes its slice of such a layer's output, and an ``all_gather``
  over the group rebuilds the whole activation (its backward sums the
  gradient over the group and keeps the rank's slice).

:func:`make_mesh` builds the grid, and inside a run of ranks the process
groups of the caller's data group and model group. :func:`launch` starts
the ranks: one process each (``torch.multiprocessing`` spawn), joined by a
``file://`` rendezvous in a temporary directory (no TCP port), each running
``fn(device, *args)`` and handing its return value back to the caller.

The backend is the caller's choice and nothing changes it: ``nccl`` with
one card per rank (rank r on ``cuda:r``), or ``gloo`` for ranks on the CPU
or sharing one card (every rank on ``device``).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device

AXES = ("data", "model")
# a PartitionSpec's counterpart: the mesh axis each tensor dimension is split
# over (None: whole), () for a replicated tensor
Spec = Tuple[Optional[str], ...]


@dataclass
class Mesh:
    """``grid[d, m]`` is the rank at data index ``d`` and model index ``m``.
    Inside a run of ranks, ``rank`` is the caller's and ``groups`` its
    process groups: ``groups["data"]`` the ranks that share its model index
    (they split the batch), ``groups["model"]`` those that share its data
    index (they split the wide layers)."""

    grid: np.ndarray
    rank: Optional[int] = None
    groups: Dict[str, Any] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.grid.shape))

    @property
    def index(self) -> Tuple[int, int]:
        """The caller's (data, model) index."""
        d, m = np.argwhere(self.grid == self.rank)[0]
        return int(d), int(m)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """A (data, model) grid of ``n_devices`` ranks (the world's size inside
    a run), ``dp * tp == n_devices``; with only ``n_devices`` given all of it
    goes to data parallelism. Inside a run (``torch.distributed``
    initialized) every rank must call it alike: it creates the process group
    of every data and model group, in one order, and keeps the caller's."""
    running = dist.is_available() and dist.is_initialized()
    if n_devices is None:
        n_devices = dist.get_world_size() if running else 1
    if dp is None:
        dp = n_devices // tp
    assert dp * tp == n_devices, f"dp({dp}) * tp({tp}) != devices({n_devices})"
    mesh = Mesh(np.arange(n_devices).reshape(dp, tp))
    if running:
        assert dist.get_world_size() == n_devices, (
            f"a mesh of {n_devices} ranks in a world of {dist.get_world_size()}")
        mesh.rank = dist.get_rank()
        d, m = mesh.index
        for col in range(tp):
            group = dist.new_group([int(r) for r in mesh.grid[:, col]])
            if col == m:
                mesh.groups["data"] = group
        for row in range(dp):
            group = dist.new_group([int(r) for r in mesh.grid[row]])
            if row == d:
                mesh.groups["model"] = group
    return mesh


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """The caller's slice of a global batch (a tensor or array, or a tuple,
    list or dict of them): its data index's equal share of the leading
    axis. Every loss normaliser counts on the shares being equal."""
    dp = mesh.shape["data"]
    d, _ = mesh.index

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(one(v) for v in x)
        assert len(x) % dp == 0, f"a batch of {len(x)} does not split over dp={dp}"
        k = len(x) // dp
        return x[d * k:(d + 1) * k]

    return one(batch)


# the output-channel dimension of each kernel layout: torch's conv weight is
# [out, in, kh, kw], a linear layer's [out, in], a transposed conv's
# [in, out, kh, kw] (flax keeps it last in each)
_OUT_DIM = {nn.Conv2d: 0, nn.Linear: 0, nn.ConvTranspose2d: 1}


def _out_dim(module: nn.Module) -> Optional[int]:
    for kind, dim in _OUT_DIM.items():
        if isinstance(module, kind):
            return dim
    return None


def param_shardings(mesh: Mesh, model: nn.Module, min_channels: int = 64) -> Dict[str, Spec]:
    """The JAX package's tensor-parallel rule for a conv net, by parameter
    name: a conv or dense kernel whose output channels are at least
    ``min_channels`` and divide by tp is split over ``model`` on its
    output-channel dimension; everything else, every 1-D parameter (biases,
    BatchNorm scales) included, is replicated."""
    tp = mesh.shape["model"]
    specs: Dict[str, Spec] = {}
    for mod_name, module in model.named_modules():
        for p_name, param in module.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            dim = _out_dim(module) if p_name == "weight" and param.ndim >= 2 else None
            out = param.shape[dim] if dim is not None else 0
            if tp <= 1 or dim is None or out < min_channels or out % tp:
                specs[name] = ()
            else:
                spec = [None] * param.ndim
                spec[dim] = "model"
                specs[name] = tuple(spec)
    return specs


class _GatherSlices(torch.autograd.Function):
    """All-gather of every rank's slice along ``dim``; the backward sums the
    gradient over the group (an all-reduce, which every backend has) and
    keeps the rank's slice, as a reduce-scatter would."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.index = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        return grad.chunk(n, ctx.dim)[ctx.index], None, None


def gather_slices(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherSlices.apply(x, group, dim)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a group; its backward is the same sum of the
    gradients. ``torch.distributed.nn.functional.all_reduce`` computes the
    same but is deprecated (a FutureWarning on every call), and the
    functional collectives it points to carry no gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOver.apply(x, group)


def _split_forward(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A split layer's forward: this rank's output channels (its weight
    slice, no bias), gathered over the model group, then the whole bias."""
    w = module.weight
    if isinstance(module, nn.Linear):
        y, dim = F.linear(x, w), -1
    elif isinstance(module, nn.ConvTranspose2d):
        assert module.groups == 1
        y, dim = F.conv_transpose2d(x, w, None, module.stride, module.padding,
                                    module.output_padding, 1, module.dilation), 1
    else:
        assert module.groups == 1 and module.padding_mode == "zeros"
        y, dim = F.conv2d(x, w, None, module.stride, module.padding, module.dilation), 1
    y = gather_slices(y, module.tp_group, dim)
    if module.bias is None:
        return y
    return y + (module.bias if dim == -1 else module.bias[:, None, None])


def place(model: nn.Module, mesh: Mesh, shardings: Dict[str, Spec]) -> nn.Module:
    """Keep only this rank's slice of each split parameter (its model
    index's share of the split dimension) and make its layer gather the
    output over the model group. Replicated parameters stay as they are.
    Build the optimiser after this: its state then lives with the slices."""
    _, m = mesh.index
    tp = mesh.shape["model"]
    modules = dict(model.named_modules())
    for name, spec in shardings.items():
        if "model" not in spec:
            continue
        mod_name, p_name = name.rpartition(".")[::2]
        assert p_name == "weight", name
        module = modules[mod_name]
        dim = spec.index("model")
        whole = module.weight
        size = whole.shape[dim] // tp
        module.weight = nn.Parameter(whole.detach().narrow(dim, m * size, size).clone())
        module.tp_group = mesh.groups["model"]
        module.forward = _split_forward.__get__(module)
    return model


def sum_gradients(model: nn.Module, mesh: Mesh) -> None:
    """Sum each parameter's gradient over the ranks that hold it: a split
    parameter's over its data group, every other over all ranks (one
    all-reduce of the flattened gradients per kind)."""
    split = {id(m.weight) for m in model.modules() if hasattr(m, "tp_group")}
    kinds = {"data": [], None: []}
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        kinds["data" if id(p) in split else None].append(p.grad)
    for kind, grads in kinds.items():
        if grads:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=mesh.groups[kind] if kind else None)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))


def full_state_dict(model: nn.Module, mesh: Mesh, shardings: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with every split parameter whole again (its
    slices all-gathered over the model group), on every rank."""
    state = dict(model.state_dict())
    for name, spec in shardings.items():
        if "model" in spec:
            state[name] = gather_slices(state[name], mesh.groups["model"], spec.index("model"))
    return state


def gather_params(results: Sequence[Dict[str, torch.Tensor]], grid: np.ndarray,
                  shardings: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """Whole tensors from the per-rank dicts of one data row (``results[r]``
    is rank r's ``{name: tensor}``): a split tensor is its model ranks'
    slices joined in order, a replicated one rank ``grid[0, 0]``'s."""
    row = [int(r) for r in grid[0]]
    out = {}
    for name, value in results[row[0]].items():
        spec = shardings.get(name, ())
        if "model" in spec:
            out[name] = torch.cat([results[r][name] for r in row], spec.index("model"))
        else:
            out[name] = value
    return out


# ---------------------------------------------------------------------------
# launching the ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, n: int, backend: str, device: Optional[str], workdir: str,
               timeout_s: float, fn: Callable, args: tuple) -> None:
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # the ranks share the host's cores: an equal share each, not
            # every core each
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "rendezvous"),
                            world_size=n, rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))


def launch(fn: Callable, n: int, backend: str = "nccl", device=None, args: tuple = (),
           timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(device, *args)`` on ``n`` ranks and return their results in
    rank order (each moved to the CPU by ``torch.save``/``torch.load``).

    ``fn`` must be a module-level function of this package (a spawned
    process imports the module that defines it). ``backend="nccl"`` puts
    rank r on ``cuda:r``, needs ``n`` cards and takes no ``device``;
    ``"gloo"`` puts every rank on ``device`` (``cuda:0`` unless told, or
    ``"cpu"``): a given device means gloo. A rank that
    raises, or a collective that waits past ``timeout_s``, fails the
    launch with that rank's traceback."""
    if backend == "nccl":
        if device is not None:
            raise ValueError("nccl puts rank r on cuda:r; pass no device")
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"nccl with {n} ranks needs {n} CUDA devices; this host has "
                               f"{torch.cuda.device_count()} (share one card with backend='gloo')")
    elif backend == "gloo":
        device = str(resolve_device(device))
    else:
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    workdir = tempfile.mkdtemp(prefix="mesh-")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n, backend, device, workdir, timeout_s, fn, args), nprocs=n,
            join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
