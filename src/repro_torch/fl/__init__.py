from repro_torch.fl.simulation import DevicePool, RoundSystemState
from repro_torch.fl.tasks import MLPTask
from repro_torch.fl.client import local_train, probing_epoch
from repro_torch.fl.aggregation import AGGREGATORS, fedavg, robust_aggregate
from repro_torch.fl.server import FLConfig, FLServer, RoundContext, RoundResult
from repro_torch.fl.telemetry import TELEMETRY_FEATURES, DeviceTelemetry
from repro_torch.fl.engine import (
    ClientExecutor,
    ClientRequest,
    ExecutionResult,
    RoundPlan,
    SequentialExecutor,
    available_executors,
    build_requests,
    build_round_plan,
    make_executor,
)
from repro_torch.fl.registry import available_policies, build_policy
from repro_torch.fl.scenarios import (
    ScenarioSpec,
    available_scenarios,
    build_scenario,
    get_scenario,
    register_scenario,
)

__all__ = [
    "DevicePool", "RoundSystemState",
    "ScenarioSpec", "build_scenario", "register_scenario", "get_scenario",
    "available_scenarios",
    "MLPTask", "local_train", "probing_epoch",
    "fedavg", "AGGREGATORS", "robust_aggregate",
    "FLServer", "FLConfig", "RoundContext", "RoundResult",
    "DeviceTelemetry", "TELEMETRY_FEATURES",
    "RoundPlan", "build_round_plan", "build_requests",
    "ClientExecutor", "ClientRequest", "ExecutionResult",
    "SequentialExecutor", "make_executor", "available_executors",
    "build_policy", "available_policies",
]
