"""msf_loam_tpu — LiDAR-inertial SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
kekeliu-whu/MSF_LOAM (LOAM + IMU preintegration + GPS pose-graph fusion).
See SURVEY.md for the reference layer map this build targets.
"""

__version__ = "0.1.0"

from msf_loam_tpu.config import MsfLoamConfig
from msf_loam_tpu.core.se3 import Pose
