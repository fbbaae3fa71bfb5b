"""SimDC core on PyTorch: the federated round of the paper, end to end.

Exports what the port covers so far — calibration, allocation, DeviceFlow,
update buffers, aggregation, monitoring, the grade-partitioned round engine
(slice 1), continuous-batching serving (slice 2) and the multi-task
scheduler (``TaskEngine`` with elastic grants and preemption).
"""
from repro_torch.core.allocation import (
    AllocationResult,
    GradeRuntime,
    fixed_ratio_allocation,
    solve_allocation,
    solve_allocation_bruteforce,
)
from repro_torch.core.calibration import (
    RuntimeCalibrator,
    ScheduleEstimate,
    calibrate_runtimes,
    monte_carlo_schedules,
    table1_runtime,
)
from repro_torch.core.deviceflow import (
    ArrivalBatch,
    Delivery,
    DeviceFlow,
    Message,
    Shelf,
    VirtualClock,
)
from repro_torch.core.federation import (
    AggregationService,
    ClientCountTrigger,
    SampleThresholdTrigger,
    ScheduledTrigger,
    fedavg_delta,
    fused_fedavg_delta,
    handles_align,
    polynomial_staleness,
    weighted_average,
)
from repro_torch.core.monitoring import (
    InMemorySink,
    MetricEvent,
    MetricsBus,
    TaskMonitor,
    wire_aggregation_service,
)
from repro_torch.core.scheduler import (
    DrainResult,
    ResourceManager,
    ResourcePool,
    StrandedTasksError,
    TaskEngine,
    TaskExecution,
    TaskManager,
    TaskRunner,
    TaskScheduler,
    TaskState,
)
from repro_torch.core.serving import (
    ContinuousBatchingEngine,
    ContinuousServer,
    RequestRecord,
    ServeCostModel,
    ServingReport,
)
from repro_torch.core.simulation import (
    DeviceTier,
    FederatedRoundOutcome,
    GradePlanEntry,
    GradeRoundBreakdown,
    HybridSimulation,
    LogicalTier,
    RoundPlan,
)
from repro_torch.core.strategies import (
    AccumulatedStrategy,
    DispatchPoint,
    TimeIntervalStrategy,
    TimePointStrategy,
    discretize_curve,
)
from repro_torch.core.task import (
    GradeSpec,
    OperatorFlow,
    Task,
    TaskQueue,
    register_operator,
)
from repro_torch.core.traffic_curves import (
    TrafficCurve,
    arrival_quantiles,
    diurnal,
    right_tailed_normal,
    table2_curves,
)
from repro_torch.core.updates import (
    UpdateBuffer,
    UpdateHandle,
    materialize_handles,
)

__all__ = [
    "AllocationResult", "GradeRuntime", "fixed_ratio_allocation",
    "solve_allocation", "solve_allocation_bruteforce",
    "RuntimeCalibrator", "ScheduleEstimate", "calibrate_runtimes",
    "monte_carlo_schedules", "table1_runtime",
    "ArrivalBatch", "Delivery", "DeviceFlow", "Message", "Shelf",
    "VirtualClock",
    "AggregationService", "ClientCountTrigger", "SampleThresholdTrigger",
    "ScheduledTrigger", "fedavg_delta", "fused_fedavg_delta",
    "handles_align", "polynomial_staleness", "weighted_average",
    "InMemorySink", "MetricEvent", "MetricsBus", "TaskMonitor",
    "wire_aggregation_service",
    "DrainResult", "ResourceManager", "ResourcePool", "StrandedTasksError",
    "TaskEngine", "TaskExecution", "TaskManager", "TaskRunner", "TaskScheduler",
    "TaskState",
    "ContinuousBatchingEngine", "ContinuousServer", "RequestRecord",
    "ServeCostModel", "ServingReport",
    "DeviceTier", "FederatedRoundOutcome", "GradePlanEntry",
    "GradeRoundBreakdown", "HybridSimulation", "LogicalTier", "RoundPlan",
    "AccumulatedStrategy", "DispatchPoint", "TimeIntervalStrategy",
    "TimePointStrategy", "discretize_curve",
    "GradeSpec", "OperatorFlow", "Task", "TaskQueue", "register_operator",
    "TrafficCurve", "arrival_quantiles", "diurnal", "right_tailed_normal",
    "table2_curves",
    "UpdateBuffer", "UpdateHandle", "materialize_handles",
]
