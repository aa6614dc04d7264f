"""Every file of the JAX package has its counterpart in the port.

Both packages are parsed with ``ast``, never imported. There is one case per
source file of ``cuauv_vision_pipeline_tpu/``. A case passes when:

- the port has a file at the same path under
  ``cuauv_vision_pipeline_tpu_torch/``, or the file is in ``NOT_PORTED``
  with the reason it is left out;
- each public top-level ``def``/``class`` of a ported ``.py`` file is bound
  under the same name at the top of the port's file, or ``COUNTERPARTS``
  names the port's function that does its work, or ``LEFT_OUT`` gives the
  reason it has none;
- each top-level function that reaches ``pl.pallas_call`` (directly, or by
  naming such a function of its file) is named, by file and ``def`` line, in
  a ``replaces=`` of ``chip_smoke.py``'s kernel rows, which hold its CUDA
  counterpart against its plain version on the card.

A JAX file or name added later fails its case until it is ported or listed.
"""

import ast
import functools
from pathlib import Path
from typing import Dict, Set, Tuple

import pytest
import torch_cpu_pool  # noqa: F401  (the port's tests run torch at one CPU thread)

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "cuauv_vision_pipeline_tpu"
PORT = REPO / "cuauv_vision_pipeline_tpu_torch"
SOURCE_SUFFIXES = {".py", ".cpp", ".hpp", ".h", ".yaml", ".conf"}
SOURCE_NAMES = {"Makefile"}
BUILT = {"__pycache__", "build"}  # directories that builds and imports fill

NOT_PORTED = {
    "core/jaxconfig.py": "XLA's compile settings; eager torch compiles nothing",
    "engine/prewarm.py": "warms XLA's compiled lanes; eager torch compiles nothing",
    "utils/_jit.py": "jit wrappers for XLA; eager torch compiles nothing",
    "ops/pallas/__init__.py": "the Pallas kernels' package; the port's kernels are csrc/*.cu",
    "ops/pallas/ccl_kernel.py": "Pallas TPU kernel; replaced by csrc/ccl.cu (ops/cuda/ccl_kernel.py)",
    "ops/pallas/morph_kernel.py": "Pallas TPU kernel; replaced by csrc/morph.cu (ops/cuda/morph_kernel.py)",
    "native/Makefile": "the port builds its C++ with g++ from native/__init__.py",
}
# "JAX file:name" -> the port's "file:name"s that do its work
COUNTERPARTS = {
    "models/yolo/decode.py:nms_fixed": ("ops/cuda/nms_kernel.py:nms_fixed_cuda",),
    "models/yolo/predictor.py:quantize_weights_int8": ("models/yolo/quant.py:quantize_weights_int8",),
    "ops/ccl.py:propagate_min": ("ops/ccl.py:label", "ops/cuda/ccl_kernel.py:label_cuda"),
    "native/__init__.py:build": ("native/__init__.py:library_path", "native/__init__.py:build_binary"),
    "parallel/mesh.py:data_parallel_sharding": ("parallel/mesh.py:shard_batch",),
    "parallel/mesh.py:replicated": ("parallel/mesh.py:place",),
}
# "JAX file:name" -> why the port has no counterpart
LEFT_OUT = {
    "models/yolo/model.py:preprocess": "the gather-form letterbox; preprocess_fused gives the same u8 values "
                                       "at the serving sizes",
}


def is_source(path: Path) -> bool:
    return path.is_file() and (path.suffix in SOURCE_SUFFIXES or path.name in SOURCE_NAMES) \
        and not BUILT & set(path.parts)


JAX_FILES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*") if is_source(p))


@functools.lru_cache(maxsize=None)
def parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def public_defs(tree: ast.Module) -> Dict[str, ast.AST]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def bound_names(tree: ast.Module) -> Set[str]:
    """Every name the module binds at its top: defs, classes, assignments, imports."""
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in n.names)
        elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names.update(x.id for t in targets for x in ast.walk(t) if isinstance(x, ast.Name))
    return names


def pallas_functions(tree: ast.Module) -> Dict[str, int]:
    """Top-level functions that reach ``pallas_call`` -> their ``def`` line."""
    funcs = {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    refs = {name: {x.id if isinstance(x, ast.Name) else x.attr for x in ast.walk(f)
                   if isinstance(x, ast.Name) or isinstance(x, ast.Attribute)}
            for name, f in funcs.items()}
    reach = {name for name, r in refs.items() if "pallas_call" in r}
    while True:
        more = {name for name, r in refs.items() if r & reach} - reach
        if not more:
            return {name: funcs[name].lineno for name in reach}
        reach |= more


@functools.lru_cache(maxsize=None)
def smoke_replaces() -> Set[Tuple[str, int]]:
    """(file, line) of every ``replaces="file:line"`` in chip_smoke.py."""
    out = set()
    for node in ast.walk(parse(REPO / "chip_smoke.py")):
        if isinstance(node, ast.keyword) and node.arg == "replaces" and isinstance(node.value, ast.Constant):
            file, _, line = node.value.value.rpartition(":")
            out.add((file, int(line)))
    return out


def port_has(spec: str) -> bool:
    file, name = spec.split(":")
    return (PORT / file).is_file() and name in bound_names(parse(PORT / file))


def test_one_case_per_jax_source_file():
    assert len(JAX_FILES) >= 120 and "core/base.py" in JAX_FILES and "native/Makefile" in JAX_FILES


@pytest.mark.parametrize("rel", JAX_FILES)
def test_jax_file_has_its_counterpart(rel):
    jax_file, port_file = JAX / rel, PORT / rel
    if rel in NOT_PORTED:
        assert not port_file.exists(), f"{rel} is ported now: take it off NOT_PORTED"
    else:
        assert port_file.is_file(), f"{rel} has no port at {port_file.relative_to(REPO)} and is not in NOT_PORTED"
    if jax_file.suffix != ".py":
        return
    tree = parse(jax_file)
    if port_file.is_file():
        ported = bound_names(parse(port_file))
        for name in public_defs(tree):
            key = f"{rel}:{name}"
            if name in ported:
                assert key not in COUNTERPARTS and key not in LEFT_OUT, f"{key} is ported under its name: unlist it"
            elif key in COUNTERPARTS:
                for spec in COUNTERPARTS[key]:
                    assert port_has(spec), f"{key}: its counterpart {spec} is not in the port"
            else:
                assert key in LEFT_OUT, f"{key} has no counterpart in {port_file.relative_to(REPO)}"
    replaced = smoke_replaces()
    for name, line in pallas_functions(tree).items():
        assert (f"cuauv_vision_pipeline_tpu/{rel}", line) in replaced, (
            f"{rel}:{line} {name} reaches pl.pallas_call but no chip_smoke.py kernel row replaces it")


@pytest.mark.parametrize("table", ["COUNTERPARTS", "LEFT_OUT"])
def test_listed_names_are_jax_public_names(table):
    for key in globals()[table]:
        rel, name = key.split(":")
        assert rel in JAX_FILES and name in public_defs(parse(JAX / rel)), f"{table} lists {key}, not a JAX name"


def test_the_pallas_kernels_are_found():
    found = {f"{rel}:{name}" for rel in JAX_FILES if rel.endswith(".py")
             for name in pallas_functions(parse(JAX / rel))}
    assert found == {"ops/pallas/ccl_kernel.py:label_pallas", "ops/pallas/ccl_kernel.py:label_pallas_batched",
                     "ops/pallas/morph_kernel.py:fused_morph"}
