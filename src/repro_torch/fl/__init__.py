from repro_torch.fl.simulation import DevicePool, DeviceProfile, RoundSystemState
from repro_torch.fl.tasks import ClientTask, LMTask, MLPTask
from repro_torch.fl.client import local_train, make_parallel_local_train, probing_epoch
from repro_torch.fl.aggregation import (
    AGGREGATORS,
    STALENESS_KINDS,
    buffered_aggregate,
    compose_staleness,
    coordinate_median,
    fedavg,
    krum,
    multi_krum,
    robust_aggregate,
    staleness_weight,
    trimmed_mean,
    weighted_delta_aggregate,
)
from repro_torch.fl.attacks import (
    AttackModel,
    GaussianNoise,
    LabelSkewDrift,
    ScaledUpdate,
    SignFlip,
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
    VmappedExecutor,
    available_executors,
    build_requests,
    build_round_plan,
    executor_label,
    make_executor,
    register_executor,
)
from repro_torch.fl.registry import available_policies, build_policy, register_policy
from repro_torch.fl.scenarios import (
    RegionSpec,
    ScenarioSpec,
    available_scenarios,
    build_scenario,
    get_scenario,
    register_scenario,
)
from repro_torch.fl.topology import (
    AggregationTopology,
    HierarchicalAsyncEngine,
    TierSpec,
    available_topologies,
    get_topology,
    register_topology,
    run_topology_round,
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
    "ScenarioSpec", "RegionSpec", "build_scenario", "register_scenario",
    "get_scenario", "available_scenarios",
    "AggregationTopology", "TierSpec", "register_topology", "get_topology",
    "available_topologies", "run_topology_round", "HierarchicalAsyncEngine",
    "MLPTask", "LMTask", "ClientTask", "local_train", "probing_epoch",
    "make_parallel_local_train",
    "Trace", "ResampledFleet", "TraceSpec", "TraceLoad", "TraceAvailability",
    "SyntheticTraceSpec", "synthesize_trace",
    "read_trace_csv", "write_trace_csv", "sample_trace_path",
    "fedavg", "weighted_delta_aggregate", "AGGREGATORS", "robust_aggregate",
    "trimmed_mean", "coordinate_median", "krum", "multi_krum",
    "STALENESS_KINDS", "staleness_weight", "buffered_aggregate",
    "compose_staleness",
    "AttackModel", "SignFlip", "ScaledUpdate", "GaussianNoise",
    "LabelSkewDrift",
    "FLServer", "FLConfig", "RoundContext", "RoundResult",
    "DeviceTelemetry", "TELEMETRY_FEATURES",
    "AsyncRoundEngine", "AsyncJob", "AsyncStallError",
    "RoundPlan", "build_round_plan", "build_requests",
    "ClientExecutor", "ClientRequest", "ExecutionResult",
    "SequentialExecutor", "VmappedExecutor", "AsyncDispatchExecutor",
    "executor_label",
    "make_executor", "register_executor", "available_executors",
    "build_policy", "register_policy", "available_policies",
]
