"""No-op handler (reference handlers/stub.py); a copy of
``cuauv_vision_pipeline_tpu.handlers.stub``."""

from ..core.handlers import HandlerBase


class StubHandler(HandlerBase):
    def process(self, direction, image, *args, **kwargs):
        pass
