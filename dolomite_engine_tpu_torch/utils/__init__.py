"""Host-side utilities of the port (mirrors `dolomite_engine_tpu/utils/`)."""

from .diagnostics import (
    FlightRecorder,
    HealthMonitor,
    build_health_monitor,
    build_model_report,
    crash_reason,
    emit_model_report,
)
from .fault_tolerance import (
    StallWatchdog,
    install_preemption_handler,
    preemption_requested,
    register_crash_hook,
    request_preemption,
    reset_preemption,
    run_crash_hooks,
    uninstall_preemption_handler,
    unregister_crash_hook,
)
from .distributed import any_rank, init_distributed, sum_over_ranks, world_size
from .logger import get_logger, log_rank_0, process_index, run_rank_n, set_logger
from .mixed_precision import normalize_dtype_string, string_to_dtype
from .pydantic import BaseArgs
from .retry import TRANSIENT_IO_ERRORS, retry_io
from .telemetry import (
    QuantileSketch,
    Telemetry,
    build_telemetry,
    collect_memory_gauges,
    detect_peak_tflops_per_device,
    get_telemetry,
    install_telemetry,
    stable_config_hash,
    step_annotation,
    trace_annotation,
    uninstall_telemetry,
)
from .tracking import ExperimentsTracker, ProgressBar
from .yaml import dump_yaml, load_yaml
