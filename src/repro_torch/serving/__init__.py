from repro_torch.serving.engine import (ServeConfig, ServingEngine,  # noqa: F401
                                        pack_requests, probe_flag)
