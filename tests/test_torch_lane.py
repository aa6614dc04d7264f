"""The port's device lane (engine/lane.py) without a bus, on the CPU: which
frames a batched dispatch carries, how ``$N`` placeholders bind, how a
batched result comes back lane by lane, the lines its close logs, and the
two chains it refuses. tests/test_torch_module.py drives the same policy
through the frame bus."""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.core.base import ModuleBase, VideoMessage, VideoSource, device_fn
from cuauv_vision_pipeline_tpu_torch.core.bindings.frame_bus import ReadStatus
from cuauv_vision_pipeline_tpu_torch.engine.lane import DeviceLane


def _lane(*specs, sources=("cam",), **options):
    """A lane of a chain over ``specs`` that records what it is handed, opened
    for ``sources``."""
    handed = []

    @device_fn(*specs, **options)
    def chain(image, *, tuners, want_posts):
        handed.append(image)
        return {"value": image[..., 0, 0, 0]}, {"dbg": image} if want_posts else {}

    lane = DeviceLane(chain, torch.device("cpu"))
    lane.open(list(sources))
    return lane, handed


def _frame(v):
    return np.full((4, 6, 3), v, np.uint8)


def _message(source, data, batch=None):
    """A read of ``source``: ``data`` (an array, or a tuple of planes), and
    the batch it drained as ``(frames, acquisition times)``."""
    frames, acqs = batch or (None, None)
    return VideoMessage(source=VideoSource(source), status=ReadStatus.SUCCESS, data=data,
                        acquisition_time=0, batch_data=frames, batch_acqs=acqs)


def _close(lane):
    lines = []
    deliveries = lane.close(lambda line, always=False: lines.append(line))
    return deliveries, lines


# (device_fn options, frames the tick drained (0: the first, unbatched
# read), values of the lanes dispatched)
LANE_CHOICES = {
    "first_tick": (dict(batch=4), 0, [0]),
    "backlog_within_batch": (dict(batch=4), 3, [0, 1, 2]),
    "backlog_past_batch": (dict(batch=4), 6, [2, 3, 4, 5]),
    "latest_only_past_backlog": (dict(batch=4, latest_only_backlog=1), 3, [2]),
    "latest_only_within_backlog": (dict(batch=4, latest_only_backlog=5), 5, [1, 2, 3, 4]),
    "latest_only_past_backlog_above_batch": (dict(batch=4, latest_only_backlog=5), 6, [5]),
}


@pytest.mark.parametrize("case", sorted(LANE_CHOICES))
def test_lane_choice(case):
    """A batched dispatch carries the fresh lanes only: the newest alone
    past ``latest_only_backlog`` (checked before the batch trim), else the
    last ``batch``; the first tick its one frame. A lone frame goes as a
    ``[1,H,W,C]`` view of the bus's frame, not a copy. Each lane comes back
    oldest first with its own acquisition time; posts ride the newest."""
    options, drained, want = LANE_CHOICES[case]
    lane, handed = _lane("cam", **options)
    assert lane.read_request() is None
    frames = [_frame(v) for v in range(max(drained, 1))]
    acqs = [100 + v for v in range(len(frames))]
    lane.note("cam", ("cam",), _message("cam", frames[-1], (frames, acqs) if drained else None))
    depth = max(4, options.get("latest_only_backlog", 0) + 1)
    assert lane.read_request() == {"cam": depth}
    cache = {"cam": (frames[-1], acqs[-1])}
    assert list(lane.offer(cache, {"cam"}, dict, want_posts=True)) == []  # depth 1: one frame late
    (batch,) = handed
    assert batch.shape == (len(want), 4, 6, 3)
    assert batch[:, 0, 0, 0].tolist() == want
    if len(want) == 1:
        assert batch.data_ptr() == frames[-1].ctypes.data
    deliveries, _ = _close(lane)
    assert [(int(r["value"]), m.acquisition_time, m.newest, sorted(p)) for r, p, m in deliveries] == [
        (v, 100 + v, v == want[-1], ["dbg"] if v == want[-1] else []) for v in want]
    assert all(m.lane_acqs == [100 + v for v in want] for _, _, m in deliveries)


def test_lane_takes_the_batched_plane_of_a_multi_plane_backlog():
    lane, handed = _lane("zed[forward]", batch=2)
    frames = [(_frame(10 + v), _frame(v)) for v in range(3)]  # (depth, forward)
    lane.note("zed", ("depth", "forward"), _message("zed", frames[-1], (frames, [1, 2, 3])))
    list(lane.offer({"forward": (frames[-1][1], 3), "depth": (frames[-1][0], 3)}, {"forward"}, dict, False))
    assert handed[0][:, 0, 0, 0].tolist() == [1, 2]
    deliveries, _ = _close(lane)
    assert [m.acquisition_time for _, _, m in deliveries] == [2, 3]


@pytest.mark.parametrize("spec, sources, reads, want", [
    # "$1" binds to the first alias of the second source only
    ("$1", ("a", "b"), [("a", ("fwd",)), ("b", ("down", "depth"))], ("down",)),
    # "*" is "$0"; a later frame of the source does not rebind it
    ("*", ("zed",), [("zed", ("forward", "depth")), ("zed", ("other",))], ("forward",)),
    # a named alias never binds
    ("cam", ("cam",), [("cam", ("cam",))], ("cam",)),
])
def test_placeholder_binding(spec, sources, reads, want):
    lane, handed = _lane(spec, sources=sources)
    for source, aliases in reads:
        lane.note(source, aliases, _message(source, tuple(_frame(0) for _ in aliases)))
    assert lane.aliases == want
    cache = {a: (_frame(7), 5) for a in want}
    assert list(lane.offer(cache, set(), dict, True)) == [] and handed == []  # nothing fresh
    list(lane.offer(cache, set(want), dict, True))
    (result, posts, meta), = _close(lane)[0]
    assert meta.aliases == want and meta.acquisition_time == 5 and meta.lane_acqs is None
    assert int(result["value"]) == 7 and sorted(posts) == ["dbg"]
    lane.open(list(sources))  # a new run loop starts unbound
    assert lane.aliases == lane.spec_aliases
    lane.executor.close()


def test_close_logs_how_the_dispatches_ran():
    lane, _ = _lane("cam", depth=2, async_fetch=True)
    deliveries = []
    for v in range(3):
        deliveries += lane.offer({"cam": (_frame(v), v)}, {"cam"}, dict, True)
    drained, lines = _close(lane)
    assert [int(r["value"]) for r, _, _ in deliveries + drained] == [0, 1, 2]
    assert lines == ['graph calls: {"eager": 3, "capture": 0, "replay": 0, "fallback": 0}',
                     'h2d copies: {"staged": 0, "pageable": 0}']
    assert not lane.abandoned


class TwoChains(ModuleBase):
    @device_fn("cam")
    def first(self, image, *, tuners, want_posts):
        return {}, {}

    @device_fn("cam")
    def second(self, image, *, tuners, want_posts):
        return {}, {}


class BatchTwoSpecs(ModuleBase):
    @device_fn("zed[forward]", "zed[depth]", batch=2)
    def chain(self, forward, depth, *, tuners, want_posts):
        return {}, {}


@pytest.mark.parametrize("module_cls, message", [
    (TwoChains, "TwoChains registers more than one @device_fn; a module has exactly one device chain"),
    (BatchTwoSpecs, "@device_fn(batch=N) requires a single source spec"),
])
def test_lane_refuses(module_cls, message):
    module = module_cls(["cam"], [], argv=["--device", "cpu"])
    with pytest.raises(RuntimeError) as raised:
        DeviceLane.find(module, lambda line, always=False: None)
    assert str(raised.value) == message
