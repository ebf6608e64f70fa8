"""Runtime helpers of the port (``repro/runtime/``): the step monitor."""
from repro_torch.runtime.monitor import StepMonitor  # noqa: F401
