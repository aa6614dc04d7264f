"""``python -m cuauv_vision_pipeline_tpu_torch.native [all|stubcheck|test|TARGET ...]``."""

from . import main

if __name__ == "__main__":
    raise SystemExit(main())
