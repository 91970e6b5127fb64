"""Engine presets ("model zoo") for common deployment shapes.

The reference ships one hard-wired configuration (VLP16 @ 10 Hz,
config/params.yaml); this package parameterizes the same pipeline and these
factories capture the tested operating points.
"""

from lidar_odometry_demo_tpu_torch.models.presets import (  # noqa: F401
    vlp16_default,
    vlp16_fast,
    vlp16_high_accuracy,
    tiny_test,
)

__all__ = ["vlp16_default", "vlp16_fast", "vlp16_high_accuracy", "tiny_test"]
