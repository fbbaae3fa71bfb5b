"""SimDC core on PyTorch: the federated round of the paper, end to end.

Exports what the port covers so far — calibration, allocation, DeviceFlow,
update buffers, aggregation, the grade-partitioned round engine (slice 1)
and continuous-batching serving (slice 2).  The scheduler and monitoring
modules are not ported yet (ROADMAP P8, P1).
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
    calibrate_runtimes,
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
    "RuntimeCalibrator", "calibrate_runtimes", "table1_runtime",
    "ArrivalBatch", "Delivery", "DeviceFlow", "Message", "Shelf",
    "VirtualClock",
    "AggregationService", "ClientCountTrigger", "SampleThresholdTrigger",
    "ScheduledTrigger", "fedavg_delta", "fused_fedavg_delta",
    "handles_align", "polynomial_staleness", "weighted_average",
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
