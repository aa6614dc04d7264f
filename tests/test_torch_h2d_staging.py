"""``DevicePipeline.to_device`` on the CPU: no staging. The tensor shares
the numpy array's memory, nothing is counted, the ``executor.h2d`` span's
args are its bytes alone, and each camera array reaches ``to_device`` with
its argument position, through a wrapper as the benchmark's (the staged
path on a card: ``test_torch_h2d_staging_cuda.py``)."""

import numpy as np
import pytest
import torch
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu_torch.core import trace
from cuauv_vision_pipeline_tpu_torch.engine.executor import DevicePipeline, StreamExecutor

CPU = torch.device("cpu")


@pytest.mark.parametrize("array", [
    np.zeros((6, 8, 3), np.uint8),
    np.zeros((4, 6, 8, 3), np.uint8),
    np.zeros((6, 8), np.float32),
    np.zeros((6, 8, 3), np.uint8)[:, ::2],
], ids=["frame", "lanes", "depth", "strided"])
def test_on_the_cpu_to_device_shares_the_array_and_counts_nothing(array):
    pipe = DevicePipeline(lambda x: x, CPU)
    t = pipe.to_device(array)
    assert np.shares_memory(t.numpy(), array)
    array[(0,) * array.ndim] = 7
    assert t[(0,) * array.ndim].item() == 7
    assert pipe.h2d_counts == {"staged": 0, "pageable": 0}
    assert pipe.copy_stream is None


def test_a_tensor_argument_passes_through_untouched():
    pipe = DevicePipeline(lambda x: x, CPU)
    t = torch.zeros(3)
    assert pipe.to_device(t, 1) is t
    assert pipe.h2d_counts == {"staged": 0, "pageable": 0}


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


def test_each_camera_reaches_to_device_with_its_position_and_a_bytes_only_span(on):
    pipe = DevicePipeline(lambda left, right: {"d": left.to(torch.int16) - right}, CPU)
    seen = []
    inner = pipe.to_device

    def wrapped(*args, **kwargs):  # as the benchmark wraps it
        seen.append(args[1:])
        return inner(*args, **kwargs)

    pipe.to_device = wrapped
    ex = StreamExecutor(pipe, depth=1)
    left, right = np.full((4, 5, 3), 9, np.uint8), np.full((4, 5, 3), 2, np.uint8)
    ex.submit((left, right))
    ((out, _),) = ex.flush()
    ex.close()
    assert (out["d"] == 7).all()
    assert seen == [(0,), (1,)]
    h2d = [e for e in on.events() if e.name == "executor.h2d"]
    assert [e.args for e in h2d] == [{"bytes": 60}, {"bytes": 60}]
    assert pipe.h2d_counts == {"staged": 0, "pageable": 0}
