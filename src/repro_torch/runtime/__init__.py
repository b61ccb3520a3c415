"""Runtime of the port (port of `repro.runtime`): the capture guard, the
fault-tolerant training loop and straggler detection."""
from repro_torch.runtime.fault import FaultTolerantLoop, PreemptionGuard  # noqa: F401
from repro_torch.runtime.straggler import StragglerDetector  # noqa: F401
