from pbs_tpu_torch.utils.clock import Clock, MonotonicClock, VirtualClock

__all__ = ["Clock", "MonotonicClock", "VirtualClock"]
