"""The real-time runtime: the native pacer, telemetry ring and state channel
(``native``), the paced loop (``loop``) and the end-to-end measurement
(``realtime_bench``, imported on its own: it pulls in the solver)."""

from .loop import TELEMETRY_DTYPE, RealtimeLoop, realtime_scheduling  # noqa: F401
from .native import RatePacer, StateChannel, TelemetryRing, build_library  # noqa: F401
