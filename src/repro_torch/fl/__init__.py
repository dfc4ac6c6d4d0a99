from repro_torch.fl.simulation import DevicePool, DeviceProfile, RoundSystemState
from repro_torch.fl.tasks import ClientTask, MLPTask
from repro_torch.fl.client import local_train, probing_epoch
from repro_torch.fl.aggregation import (
    AGGREGATORS,
    STALENESS_KINDS,
    buffered_aggregate,
    fedavg,
    robust_aggregate,
    staleness_weight,
    weighted_delta_aggregate,
)
from repro_torch.fl.server import FLConfig, FLServer, RoundContext, RoundResult
from repro_torch.fl.telemetry import TELEMETRY_FEATURES, DeviceTelemetry
from repro_torch.fl.async_engine import AsyncJob, AsyncRoundEngine, AsyncStallError
from repro_torch.fl.engine import (
    AsyncDispatchExecutor,
    ClientExecutor,
    ClientRequest,
    ExecutionResult,
    RoundPlan,
    SequentialExecutor,
    available_executors,
    build_requests,
    build_round_plan,
    executor_label,
    make_executor,
    register_executor,
)
from repro_torch.fl.registry import available_policies, build_policy, register_policy
from repro_torch.fl.scenarios import (
    ScenarioSpec,
    available_scenarios,
    build_scenario,
    get_scenario,
    register_scenario,
)
from repro_torch.fl.traces import (
    ResampledFleet,
    SyntheticTraceSpec,
    Trace,
    TraceAvailability,
    TraceLoad,
    TraceSpec,
    read_trace_csv,
    sample_trace_path,
    synthesize_trace,
    write_trace_csv,
)

__all__ = [
    "DevicePool", "DeviceProfile", "RoundSystemState",
    "ScenarioSpec", "build_scenario", "register_scenario", "get_scenario",
    "available_scenarios",
    "MLPTask", "ClientTask", "local_train", "probing_epoch",
    "Trace", "ResampledFleet", "TraceSpec", "TraceLoad", "TraceAvailability",
    "SyntheticTraceSpec", "synthesize_trace",
    "read_trace_csv", "write_trace_csv", "sample_trace_path",
    "fedavg", "weighted_delta_aggregate", "AGGREGATORS", "robust_aggregate",
    "STALENESS_KINDS", "staleness_weight",
    "buffered_aggregate",
    "FLServer", "FLConfig", "RoundContext", "RoundResult",
    "DeviceTelemetry", "TELEMETRY_FEATURES",
    "AsyncRoundEngine", "AsyncJob", "AsyncStallError",
    "RoundPlan", "build_round_plan", "build_requests",
    "ClientExecutor", "ClientRequest", "ExecutionResult",
    "SequentialExecutor", "AsyncDispatchExecutor", "executor_label",
    "make_executor", "register_executor", "available_executors",
    "build_policy", "register_policy", "available_policies",
]
