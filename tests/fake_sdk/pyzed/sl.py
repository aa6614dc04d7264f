"""A test double of the ZED SDK's ``pyzed.sl``: the calls the ZED capture
sources make, serving deterministic HD720 frames.

* the eyes: BGRA u8 ``[720, 1280, 4]`` of the synthetic ``buoy_frame``
  scene (the right eye a little later in the disc's orbit than the left,
  so a swapped plane order shows), alpha 255;
* depth: float32 ``[720, 1280]`` in metres with NaN, +inf and -inf holes;
* normals: float32 ``[720, 1280, 4]`` (XYZ in [-1, 1], W 0) with NaNs.

Frame ``k`` of a camera is ``frame(k)``; the double cycles ``CYCLE``
distinct frames. Only tests and ``chip_smoke.py``'s orchestration phase put
this directory on a module path (``PYTHONPATH=tests/fake_sdk``, or
``sys.modules``); the package never falls back to it.
"""

from __future__ import annotations

import enum
import functools

import numpy as np

from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame

HEIGHT, WIDTH = 720, 1280  # HD720
CYCLE = 4


class ERROR_CODE(enum.Enum):
    SUCCESS = 0
    FAILURE = 1


class RESOLUTION(enum.Enum):
    HD720 = 0


class DEPTH_MODE(enum.Enum):
    NEURAL = 0


class UNIT(enum.Enum):
    METER = 0


class VIEW(enum.Enum):
    LEFT = 0
    RIGHT = 1


class MEASURE(enum.Enum):
    DEPTH = 0
    NORMALS = 1


class VIDEO_SETTINGS(enum.Enum):
    BRIGHTNESS = 0
    CONTRAST = 1
    HUE = 2
    SATURATION = 3
    GAMMA = 4
    SHARPNESS = 5
    WHITEBALANCE_TEMPERATURE = 6
    EXPOSURE = 7
    GAIN = 8
    AEC_AGC = 9
    WHITEBALANCE_AUTO = 10


class InitParameters:
    def __init__(self) -> None:
        self.camera_resolution = RESOLUTION.HD720
        self.depth_mode = DEPTH_MODE.NEURAL
        self.coordinate_units = UNIT.METER
        self.depth_minimum_distance = 0.5
        self.depth_maximum_distance = 10.0
        self.camera_fps = 30


class RuntimeParameters:
    pass


def _bgra(bgr: np.ndarray) -> np.ndarray:
    return np.concatenate([bgr, np.full(bgr.shape[:2] + (1,), 255, np.uint8)], -1)


def frame(k: int):
    """(left BGRA, right BGRA, depth, normals) of frame ``k`` (mod CYCLE)."""
    return _frame(k % CYCLE)


@functools.lru_cache(maxsize=CYCLE)
def _frame(k: int):
    left = _bgra(buoy_frame((HEIGHT, WIDTH), 0.5 * k))
    right = _bgra(buoy_frame((HEIGHT, WIDTH), 0.5 * k + 0.1))
    rng = np.random.default_rng(1000 + k)
    depth = rng.uniform(0.3, 12.0, (HEIGHT, WIDTH)).astype(np.float32)
    holes = rng.random((HEIGHT, WIDTH))
    depth[holes < 0.02] = np.nan
    depth[(holes >= 0.02) & (holes < 0.03)] = np.inf
    depth[(holes >= 0.03) & (holes < 0.04)] = -np.inf
    normals = np.zeros((HEIGHT, WIDTH, 4), np.float32)
    normals[..., :3] = rng.uniform(-1.0, 1.0, (HEIGHT, WIDTH, 3))
    normals[rng.random((HEIGHT, WIDTH)) < 0.02, :3] = np.nan
    return left, right, depth, normals


class Mat:
    def __init__(self) -> None:
        self._data = None

    def get_data(self) -> np.ndarray:
        return self._data


class Camera:
    def __init__(self) -> None:
        self.settings = {}
        self.grabbed = 0

    def open(self, init: InitParameters) -> ERROR_CODE:
        self.init = init
        return ERROR_CODE.SUCCESS

    def set_camera_settings(self, setting: VIDEO_SETTINGS, value: int) -> None:
        self.settings[setting] = value

    def grab(self, runtime: RuntimeParameters) -> ERROR_CODE:
        self.grabbed += 1
        return ERROR_CODE.SUCCESS

    def retrieve_image(self, mat: Mat, view: VIEW) -> ERROR_CODE:
        mat._data = frame(self.grabbed - 1)[0 if view is VIEW.LEFT else 1]
        return ERROR_CODE.SUCCESS

    def retrieve_measure(self, mat: Mat, measure: MEASURE) -> ERROR_CODE:
        mat._data = frame(self.grabbed - 1)[2 if measure is MEASURE.DEPTH else 3]
        return ERROR_CODE.SUCCESS

    def close(self) -> None:
        pass
