from pbs_tpu_torch.telemetry.counters import DUMP_EVENTS, NUM_COUNTERS, Counter
from pbs_tpu_torch.telemetry.ledger import SLOT_BYTES, SLOT_WORDS, Ledger
from pbs_tpu_torch.telemetry.compile import CompileMeter
from pbs_tpu_torch.telemetry.profiler import TorchQuantumProfiler, TraceStats
from pbs_tpu_torch.telemetry.sampler import OverflowEvent, OverflowSampler
from pbs_tpu_torch.telemetry.source import (
    CudaBackend,
    SimBackend,
    SimPhase,
    SimProfile,
    TelemetrySource,
)

__all__ = [
    "CompileMeter",
    "Counter",
    "CudaBackend",
    "DUMP_EVENTS",
    "Ledger",
    "NUM_COUNTERS",
    "OverflowEvent",
    "OverflowSampler",
    "SLOT_BYTES",
    "SLOT_WORDS",
    "SimBackend",
    "SimPhase",
    "SimProfile",
    "TelemetrySource",
    "TorchQuantumProfiler",
    "TraceStats",
]
