from repro_torch.core.alloc import PagePoolExhausted, PoolCapacityError  # noqa: F401
from repro_torch.serving.engine import (ContinuousEngine, EngineCore, Request,  # noqa: F401
                                        RequestOutput, SamplingParams, ServeConfig,
                                        ServingEngine, pack_requests, probe_flag)
from repro_torch.serving.events import (CallbackErrorEvent, CancelledEvent,  # noqa: F401
                                        DownshiftEvent, EngineClosedError, Event,
                                        FinishedEvent, PreemptedEvent, SwappedEvent,
                                        TokenEvent, UnknownRequestError)
from repro_torch.serving.router import EngineRouter, NoReplicaError  # noqa: F401
from repro_torch.serving.scheduler import (FIFOScheduler, PriorityScheduler,  # noqa: F401
                                           Scheduler, make_scheduler)
