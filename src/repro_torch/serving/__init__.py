"""Chip-tier serving: execution of compiled plans on the GPU.

* queue    — per-lane FIFOs + round-robin pointer (:mod:`.queue`)
* policy   — static, operating-point, or continuous dispatch (:mod:`.policy`)
* executor — pad/dispatch/finish + prefetch pipeline (:mod:`.executor`)
* server   — the thin ``ChipServer`` composition (:mod:`.server`)
* fleet    — N-replica serve fleet with failover migration and
  warm-started replacement hosts (:mod:`.fleet`)
* cascade  — detector -> recognizer always-on pipelines (:mod:`.cascade`)
* temporal — delta-gated always-on video serving: skip unchanged
  frames, downshift quiet scenes (:mod:`.temporal`)
* traffic  — seeded arrival traces + replay, and seeded video *content*
  traces for the temporal tier (:mod:`.traffic`)
"""

from repro_torch.serving.cascade import (CascadePipeline,  # noqa: F401
                                         CascadeResult, calibrate_margin,
                                         margin_for_recall, margins_of)
from repro_torch.serving.fleet import (  # noqa: F401
    FaultInjector,
    FleetStats,
    ServeFleet,
)
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
    EwmaRate,
    FrameQueue,
    FrameRequest,
    FrameResult,
    plan_shared_groups,
)
from repro_torch.serving.server import ChipServer, ServeStats  # noqa: F401
from repro_torch.serving.temporal import (  # noqa: F401
    TemporalPipeline,
    TemporalResult,
    calibrate_delta_threshold,
    simulate_gate,
    threshold_for_skip,
)
from repro_torch.serving.traffic import (  # noqa: F401
    ArrivalTrace,
    VideoTrace,
    VirtualClock,
    bursty_trace,
    diurnal_trace,
    load_trace,
    make_trace,
    poisson_trace,
    replay,
    save_trace,
    video_trace,
)
