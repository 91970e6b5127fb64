"""PyTorch / CUDA port of the LiDAR odometry engine, for one NVIDIA H100.

A second package beside the JAX reference ``lidar_odometry_demo_tpu``,
with the same module names: deskew -> planar classification -> voxel
downsampling -> point-to-plane ICP against the hash-voxel keyframe map ->
keyframe update with radius eviction. The TPU kernels of that path (the
candidate re-match, the normal equations, the sorted-key search) are
hand-written CUDA kernels here (``kernels/``). Entry points (``LidarOdometry``,
``cli``) run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from lidar_odometry_demo_tpu_torch import device as _device  # noqa: F401  (turns TF32 off)
from lidar_odometry_demo_tpu_torch.config import TINY, OdometryConfig, reference_parity

__all__ = ["OdometryConfig", "TINY", "reference_parity"]
