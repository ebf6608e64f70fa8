"""Runtime helpers of the port (``repro/runtime/``): the step monitor and the
preemption handler."""
from repro_torch.runtime.monitor import StepMonitor  # noqa: F401
from repro_torch.runtime.preemption import PreemptionHandler  # noqa: F401
