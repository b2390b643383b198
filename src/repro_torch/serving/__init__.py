"""Chip-tier serving: static-batch execution of compiled plans on the GPU.

* queue    — per-lane FIFOs + round-robin pointer (:mod:`.queue`)
* policy   — the static dispatch policy (:mod:`.policy`)
* executor — pad/dispatch/finish + prefetch pipeline (:mod:`.executor`)
* server   — the thin ``ChipServer`` composition (:mod:`.server`)
* cascade  — detector -> recognizer always-on pipelines (:mod:`.cascade`)
"""

from repro_torch.serving.cascade import (CascadePipeline,  # noqa: F401
                                         CascadeResult, calibrate_margin,
                                         margin_for_recall, margins_of)
from repro_torch.serving.policy import (  # noqa: F401
    Dispatch,
    DispatchPolicy,
    LaneDispatch,
    PolicyContext,
    StaticPolicy,
)
from repro_torch.serving.queue import (  # noqa: F401
    EwmaRate,
    FrameQueue,
    FrameRequest,
    FrameResult,
    plan_shared_groups,
)
from repro_torch.serving.server import ChipServer, ServeStats  # noqa: F401
