"""The packed function's CUDA-graph bookkeeping on the CPU: the key a graph
is kept under, the eager path every CPU call takes (tagged on its
``executor.launch`` span), and the eager -> capture -> replay / fallback
sequence driven through a stand-in for the captured graph (a capture
needs a card: ``test_torch_executor_graph_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.core import trace
from cuauv_vision_pipeline_tpu_torch.engine import chains
from cuauv_vision_pipeline_tpu_torch.engine import executor as ex_mod
from cuauv_vision_pipeline_tpu_torch.ops import cuda as cuda_ops
from cuauv_vision_pipeline_tpu_torch.engine.executor import (
    CAPTURE_AT,
    GRAPH_MODES,
    MAX_KEYS,
    DevicePipeline,
    StreamExecutor,
    build_packed_fn,
    graph_key,
    pack_result,
)

CPU = torch.device("cpu")


def _frame(shape=(2, 3, 4, 3)):
    return torch.zeros(shape, dtype=torch.uint8)


def test_graph_key_takes_numpy_scalars_and_0d_arrays_as_python_numbers():
    f = _frame()
    key = graph_key((f,), {"lo": np.int32(140), "hi": np.array(255), "gain": np.float64(0.5),
                           "on": np.bool_(True)}, np.bool_(False))
    assert key == graph_key((f.clone(),), {"on": True, "gain": 0.5, "hi": 255, "lo": 140}, False)
    hash(key)
    assert key != graph_key((f,), {"lo": 141, "hi": 255, "gain": 0.5, "on": True}, False)
    assert key != graph_key((f,), {"lo": 140, "hi": 255, "gain": 0.5, "on": True}, True)


@pytest.mark.parametrize("other", [
    lambda f: (f[:1],),  # shape
    lambda f: (f.to(torch.int16),),  # dtype
    lambda f: (f, f),  # another camera
])
def test_graph_key_follows_each_argument_s_shape_dtype_and_count(other):
    f = _frame()
    assert graph_key((f,), {}, False) != graph_key(other(f), {}, False)


@pytest.mark.parametrize("value", [
    [140, 255],
    np.array([10, 20, 60], np.uint8),
    torch.tensor(3),
    {"x": 1},
    object(),
], ids=["list", "array", "tensor", "dict", "object"])
def test_graph_key_is_none_for_a_tuner_without_a_hashable_value(value):
    assert graph_key((_frame(),), {"lo": 140, "bounds": value}, False) is None


def test_graph_key_is_none_for_an_argument_that_is_not_a_tensor():
    assert graph_key((np.zeros((2, 2), np.uint8),), {}, False) is None


@pytest.fixture
def on():
    was = trace.tracer.enabled
    trace.tracer.clear()
    trace.tracer.enable()
    try:
        yield trace.tracer
    finally:
        if not was:
            trace.tracer.disable()
        trace.tracer.clear()


def _buoy_frames(n, lanes=2, shape=(24, 32)):
    out = []
    for i in range(n):
        frames = np.zeros((lanes,) + shape + (3,), np.uint8)
        frames[:, 4 + i:12 + i, 6:18 + i] = (0, 0, 255)
        out.append(frames)
    return out


def test_a_cpu_packed_fn_stays_eager_tags_its_launch_and_packs_the_same_bytes(on):
    def chain(f, *, tuners, want_posts):
        threshed, _, best = chains.red_buoy_fused(f, tuners["thresh_min"], tuners["thresh_max"])
        return best, ({"threshed": threshed} if want_posts else {})

    tuners = {"thresh_min": np.int32(140), "thresh_max": np.int32(255)}
    fn = build_packed_fn(chain, 2, "map")
    ex = StreamExecutor(DevicePipeline(fn, CPU), depth=2, async_fetch=True)
    batches = _buoy_frames(4)
    out = []
    try:
        for i, frames in enumerate(batches):
            out.extend(ex.submit((frames,), meta=i, tuners=tuners, want_posts=bool(i % 2)))
        out.extend(ex.flush())
    finally:
        ex.close()
    assert fn.graph_counts == {"eager": 4, "capture": 0, "replay": 0, "fallback": 0}
    launches = [e for e in on.events() if e.name == "executor.launch"]
    assert [e.args for e in launches] == [{"graph": "eager"}] * 4
    for (packed, spec), i in out:
        lanes = [chain(torch.from_numpy(f), tuners=tuners, want_posts=bool(i % 2)) for f in batches[i]]
        want, want_spec = pack_result(ex_mod._stack_lanes(lanes))
        assert spec == want_spec
        np.testing.assert_array_equal(packed, want.numpy())


class _StandIn:
    """A captured graph as the CPU can play it: the capture runs the call
    once on static inputs; a replay copies the arguments in and reruns it,
    its spans and wrapper launch counts taken back, as a graph's replay
    runs no Python of the chain."""

    fail = False  # the capture raises, as a call that waits for the host does
    differ = False  # the replay's bytes differ from the eager run's
    made: list = []

    def __init__(self, run, args):
        self.run = run
        self.inputs = tuple(a.clone() for a in args)
        self.packed, self.spec = run(*self.inputs)
        if self.fail:  # part of the chain was recorded, then the host read
            raise RuntimeError("operation not permitted when stream is capturing")
        self.replays = 0
        self.closed = False
        self.made.append(self)

    def matches(self, out):
        return not self.differ and out[1] == self.spec and torch.equal(out[0], self.packed)

    def replay(self, args):
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.replays += 1
        before = cuda_ops.launch_counts()
        was = trace.tracer.enabled
        trace.tracer.disable()
        try:
            self.packed, self.spec = self.run(*self.inputs)
        finally:
            if was:
                trace.tracer.enable()
        cuda_ops.add_launch_counts({k: before[k] - n for k, n in cuda_ops.launch_counts().items()})

    def close(self):
        self.closed = True


@pytest.fixture
def stand_in(monkeypatch):
    cls = type("StandIn", (_StandIn,), {"made": []})
    monkeypatch.setattr(ex_mod, "_Graph", cls)
    monkeypatch.setattr(ex_mod, "_on_one_card", lambda args: True)
    # the sequences below are written for a capture on a key's second call
    monkeypatch.setattr(ex_mod, "CAPTURE_AT", 2)
    return cls


def _sum_chain(calls):
    def chain(f, *, tuners, want_posts):
        calls.append(int(tuners["k"]))
        return {"s": f.to(torch.int64).sum() * tuners["k"]}, ({"f": f} if want_posts else {})
    return chain


def _run(fn, frames, k, want_posts=False):
    packed, spec = fn(torch.from_numpy(frames), tuners={"k": np.int32(k)}, want_posts=want_posts)
    return ex_mod.unpack_result(packed.numpy(), spec)


def test_a_key_runs_eagerly_then_captures_then_replays(stand_in, on):
    calls = []
    fn = build_packed_fn(_sum_chain(calls), 2, "map")
    batches = _buoy_frames(5)
    with on.span("executor.launch"):
        results = [_run(fn, frames, 3) for frames in batches]
    for (res, _), frames in zip(results, batches):
        np.testing.assert_array_equal(res["s"], frames.reshape(2, -1).sum(axis=1, dtype=np.int64) * 3)
    assert fn.graph_counts == {"eager": 1, "capture": 1, "replay": 3, "fallback": 0}
    (graph,) = stand_in.made
    assert graph.replays == 3 and not graph.closed
    # the first call's eager run, the capture and the check's eager run, one
    # rerun a replay; two lanes each
    assert len(calls) == 2 * (1 + 2 + 3)
    (launch,) = [e for e in on.events() if e.name == "executor.launch"]
    assert launch.args == {"graph": "replay"}  # the last call's tag


def test_a_tuner_change_or_want_posts_is_a_new_key(stand_in):
    fn = build_packed_fn(_sum_chain([]), 2, "map")
    (frames,) = _buoy_frames(1)
    for _ in range(3):
        _run(fn, frames, 3)
    res, posts = _run(fn, frames, 5)
    np.testing.assert_array_equal(res["s"], frames.reshape(2, -1).sum(axis=1, dtype=np.int64) * 5)
    _run(fn, frames, 5)
    _, posts = _run(fn, frames, 5, want_posts=True)
    np.testing.assert_array_equal(posts["f"], frames)
    assert fn.graph_counts == {"eager": 3, "capture": 2, "replay": 1, "fallback": 0}
    assert len(stand_in.made) == 2


@pytest.mark.parametrize("why", ["capture_raises", "replay_differs"])
def test_a_failed_key_runs_eagerly_for_good_and_is_never_captured_again(stand_in, why):
    setattr(stand_in, "fail" if why == "capture_raises" else "differ", True)
    calls = []
    fn = build_packed_fn(_sum_chain(calls), 2, "map")
    batches = _buoy_frames(5)
    for frames in batches:
        res, _ = _run(fn, frames, 2)
        np.testing.assert_array_equal(res["s"], frames.reshape(2, -1).sum(axis=1, dtype=np.int64) * 2)
    assert fn.graph_counts == {"eager": 1, "capture": 0, "replay": 0, "fallback": 4}
    assert len(stand_in.made) == (0 if why == "capture_raises" else 1)
    # the first eager run; the failed capture and the eager run that
    # answers it; three more fallbacks; two lanes each
    assert len(calls) == 2 * 6
    # another key is still tried
    setattr(stand_in, "fail", False)
    setattr(stand_in, "differ", False)
    for frames in batches[:3]:
        _run(fn, frames, 7)
    assert fn.graph_counts["capture"] == 1 and fn.graph_counts["replay"] == 1


def test_at_most_max_keys_are_kept_least_recently_used_out(stand_in):
    fn = build_packed_fn(_sum_chain([]), 2, "map")
    (frames,) = _buoy_frames(1)
    for k in range(1, MAX_KEYS + 2):
        _run(fn, frames, k)
        _run(fn, frames, k)
    graphs = stand_in.made
    assert len(graphs) == MAX_KEYS + 1
    assert graphs[0].closed and not any(g.closed for g in graphs[1:])
    _run(fn, frames, 1)  # dropped: eager again, then a new capture
    assert fn.graph_counts["eager"] == MAX_KEYS + 2
    _run(fn, frames, MAX_KEYS + 1)
    assert fn.graph_counts["replay"] == 1
    assert sum(fn.graph_counts[m] for m in GRAPH_MODES) == 2 * (MAX_KEYS + 1) + 2


def test_an_argument_off_the_card_runs_eagerly_even_with_the_stand_in(stand_in, monkeypatch):
    monkeypatch.setattr(ex_mod, "_on_one_card", lambda args: False)
    fn = build_packed_fn(_sum_chain([]), 2, "map")
    (frames,) = _buoy_frames(1)
    for _ in range(3):
        _run(fn, frames, 1)
    assert fn.graph_counts["eager"] == 3 and not stand_in.made


def _toy_kernel_chain(monkeypatch):
    """A chain that calls a stand-in hand-kernel wrapper once per lane,
    registered beside the real ones."""
    def toy(x):
        toy.launches += 1
        return x.to(torch.int64).sum()
    toy.launches = 0
    monkeypatch.setitem(cuda_ops.WRAPPERS, "toy", toy)

    def chain(f, *, tuners, want_posts):
        return {"s": toy(f) * tuners["k"]}, {}
    return toy, chain


def test_a_replay_counts_the_captured_launches_and_packs_in_its_own_span(stand_in, on, monkeypatch):
    toy, chain = _toy_kernel_chain(monkeypatch)
    fn = build_packed_fn(chain, 2, "map")
    batches = _buoy_frames(5)
    seen = []
    for frames in batches:
        with on.span("executor.launch"):
            _run(fn, frames, 3)
        seen.append(toy.launches)
    assert fn.graph_counts == {"eager": 1, "capture": 1, "replay": 3, "fallback": 0}
    # eager: two lanes; capture: the capture's two (which stand for the
    # check's replay) and the check's eager two; each replay two
    assert seen == [2, 6, 8, 10, 12]
    launches = [e for e in on.events() if e.name == "executor.launch"]
    packs = [e for e in on.events() if e.name == "executor.pack"]
    # one pack span per call: the eager calls' packing, a replay's copy-out
    assert [e.args["graph"] for e in launches] == ["eager", "capture", "replay", "replay", "replay"]
    assert len(packs) == 1 + 2 + 3 and {p.parent for p in packs[-3:]} == {e.id for e in launches[-3:]}


def test_a_failed_capture_takes_back_the_launches_it_counted(stand_in, monkeypatch):
    stand_in.fail = True
    toy, chain = _toy_kernel_chain(monkeypatch)
    fn = build_packed_fn(chain, 2, "map")
    for frames in _buoy_frames(3):
        _run(fn, frames, 1)
    assert fn.graph_counts == {"eager": 1, "capture": 0, "replay": 0, "fallback": 2}
    assert toy.launches == 2 * 3  # the three calls' eager runs, not the capture's


def test_a_failed_key_takes_a_slot_and_is_tried_again_once_dropped(stand_in):
    stand_in.differ = True
    fn = build_packed_fn(_sum_chain([]), 2, "map")
    (frames,) = _buoy_frames(1)
    _run(fn, frames, 0)
    _run(fn, frames, 0)  # failed
    stand_in.differ = False
    for k in range(1, MAX_KEYS):  # the failed key and MAX_KEYS - 1 graphs
        _run(fn, frames, k)
        _run(fn, frames, k)
    _run(fn, frames, 0)
    assert fn.graph_counts["fallback"] == 2 and not any(g.closed for g in stand_in.made[1:])
    _run(fn, frames, MAX_KEYS)  # a new key drops the least recently used, key 1's graph
    assert stand_in.made[1].closed
    for k in range(2, MAX_KEYS):
        _run(fn, frames, k)  # kept: replays
    _run(fn, frames, MAX_KEYS + 1)  # drops the failed key
    _run(fn, frames, 0)
    _run(fn, frames, 0)
    assert fn.graph_counts == {"eager": 1 + (MAX_KEYS - 1) + 2 + 1, "capture": MAX_KEYS,
                               "replay": MAX_KEYS - 2, "fallback": 2}


@pytest.mark.parametrize("capture_at", sorted({2, 3, CAPTURE_AT}))
def test_a_key_captures_on_call_capture_at(stand_in, monkeypatch, capture_at):
    monkeypatch.setattr(ex_mod, "CAPTURE_AT", capture_at)
    fn = build_packed_fn(_sum_chain([]), 2, "map")
    (frames,) = _buoy_frames(1)
    modes = []
    for _ in range(capture_at + 3):
        before = dict(fn.graph_counts)
        _run(fn, frames, 3)
        (mode,) = [m for m in GRAPH_MODES if fn.graph_counts[m] != before[m]]
        modes.append(mode)
    assert modes == ["eager"] * (capture_at - 1) + ["capture", "replay", "replay", "replay"]

