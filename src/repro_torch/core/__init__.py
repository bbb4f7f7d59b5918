"""Core ordered-stream-processing library of the port: the host tier
(serial, reorder, hybrid, operators, pipeline, scheduler, runtime), the
staged process runtime (procrun, shm, checkpoint, faults) and the Engine API.

Every module here is the port's own copy of its namesake in ``repro.core``
(the port imports nothing of the JAX package); only the device stage
differs, and it lives in :mod:`repro_torch.columnar.device`.
"""
from .serial import AtomicFlag, AtomicLong, SerialAssigner
from .reorder import (
    LockBasedReorderBuffer,
    NonBlockingReorderBuffer,
    ParkingReorderBuffer,
    ReorderBuffer,
    make_reorder_buffer,
)
from .hybrid import (
    HybridQueueWorklist,
    PartitionedQueueWorklist,
    SharedQueueWorklist,
    make_worklist,
)
from .operators import OpSpec, OperatorNode, OpStats, PARTITIONED, STATEFUL, STATELESS
from .pipeline import (
    CompiledPipeline,
    GraphPipeline,
    Merge,
    Split,
    compile_graph,
    compile_pipeline,
)
from .costmodel import (
    CostModel,
    OccupancyMonitor,
    TrafficMonitor,
    TrafficSnapshot,
    proportional_allocation,
    resolve_workers,
)
from .scheduler import HEURISTICS, Scheduler
from .runtime import RunReport, StreamRuntime, run_graph, run_pipeline
from .procrun import ProcessRuntime, UnstagedGraphWarning
from .shm import ShmReorderRing, ShmSpscRing
from .faults import (
    DeadLetter,
    FaultOptions,
    FaultPlan,
    FaultSpec,
    InjectedFault,
)
from .api import (
    ConfigError,
    Engine,
    EngineConfig,
    JobHandle,
    JobResult,
    PhysicalPlan,
    PlannedOp,
    PlannedStage,
    PlanVerificationError,
    ProcessOptions,
    Session,
    SessionStarvation,
    ThreadOptions,
)

__all__ = [
    "ConfigError",
    "PlanVerificationError",
    "Engine",
    "EngineConfig",
    "JobHandle",
    "JobResult",
    "PhysicalPlan",
    "PlannedOp",
    "PlannedStage",
    "ProcessOptions",
    "Session",
    "SessionStarvation",
    "ThreadOptions",
    "DeadLetter",
    "FaultOptions",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "AtomicFlag",
    "AtomicLong",
    "SerialAssigner",
    "LockBasedReorderBuffer",
    "NonBlockingReorderBuffer",
    "ParkingReorderBuffer",
    "ReorderBuffer",
    "make_reorder_buffer",
    "HybridQueueWorklist",
    "PartitionedQueueWorklist",
    "SharedQueueWorklist",
    "make_worklist",
    "OpSpec",
    "OperatorNode",
    "OpStats",
    "PARTITIONED",
    "STATEFUL",
    "STATELESS",
    "CompiledPipeline",
    "GraphPipeline",
    "Split",
    "Merge",
    "compile_graph",
    "compile_pipeline",
    "CostModel",
    "OccupancyMonitor",
    "TrafficMonitor",
    "TrafficSnapshot",
    "proportional_allocation",
    "resolve_workers",
    "HEURISTICS",
    "Scheduler",
    "RunReport",
    "StreamRuntime",
    "run_graph",
    "run_pipeline",
    "ProcessRuntime",
    "UnstagedGraphWarning",
    "ShmReorderRing",
    "ShmSpscRing",
]
