"""Back-compat shim: ``repro.serving.scheduler``'s import surface.

The counterpart of ``repro.serving.scheduler``, which keeps the names of
the pre-split serving monolith importing: the queue (``FrameQueue`` /
``FrameRequest`` / ``FrameResult`` / ``plan_shared_groups``), the
policies, the ``Executor`` and the ``ChipServer`` / ``ServeStats``.  New
code imports from :mod:`repro_torch.serving` (or the submodule) directly.
"""

from repro_torch.serving.executor import Executor  # noqa: F401
from repro_torch.serving.policy import (  # noqa: F401
    ContinuousPolicy,
    Dispatch,
    DispatchPolicy,
    LaneDispatch,
    OperatingPointPolicy,
    PolicyContext,
    StaticPolicy,
)
from repro_torch.serving.queue import (  # noqa: F401
    FrameQueue,
    FrameRequest,
    FrameResult,
    plan_shared_groups,
)
from repro_torch.serving.server import ChipServer, ServeStats  # noqa: F401
