"""or_cdchomp_tpu_torch: the CHOMP engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``or_cdchomp_tpu`` (JAX on TPU), which stays the reference:
module names mirror that package so each counterpart is easy to find.
This package imports torch and numpy only.  The two kernels (fused SDF
obstacle cost, all-pairs self-collision) are built from ``csrc/`` at
first use on the card; on CPU tensors every kernel wrapper runs its
plain PyTorch version instead.  Robots load from OpenRAVE XML
(``parse_robot_xml``) or URDF (``parse_urdf``, ``load_urdf``), and
``CHOMPModule.SendCommand`` takes the reference's command strings.
"""

__version__ = "0.1.0"

from or_cdchomp_tpu_torch.api import CHOMPModule, KinBody, Robot  # noqa: F401
from or_cdchomp_tpu_torch.models.orxml import parse_robot_xml  # noqa: F401
from or_cdchomp_tpu_torch.models.urdf import load_urdf, parse_urdf  # noqa: F401
from or_cdchomp_tpu_torch.models.wam7 import wam7  # noqa: F401
from or_cdchomp_tpu_torch.ops.voxelize import Scene  # noqa: F401
from or_cdchomp_tpu_torch.tsr import TSR  # noqa: F401
