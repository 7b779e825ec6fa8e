"""Serving layer of the port: the streaming CascadeSession engine (request
lifecycle with deadlines, flush policy, admission control, degraded
modes, retry / bisection / circuit breaker), request batching, the seeded
fault injector, and the open-loop load generator (virtual-clock DES). The
pump, the replica router and the CascadeServer shim come in later
slices."""

from repro_torch.serving.batching import (RankRequest, RankResponse,
                                          TransferBufferPool)
from repro_torch.serving.faults import (CorruptOutput, FaultConfig,
                                        FaultInjector, InjectedFault,
                                        PoisonFault, TransientFault)
from repro_torch.serving.loadgen import OpenLoopResult, run_open_loop
from repro_torch.serving.session import (CascadeSession, DegradePolicy,
                                         FlushPolicy, QueueFull, RankFuture,
                                         RetryPolicy, ServingConfig)

__all__ = ["CascadeSession", "CorruptOutput", "DegradePolicy",
           "FaultConfig", "FaultInjector", "FlushPolicy", "InjectedFault",
           "OpenLoopResult", "PoisonFault", "QueueFull", "RankFuture",
           "RankRequest", "RankResponse", "RetryPolicy", "ServingConfig",
           "TransferBufferPool", "TransientFault", "run_open_loop"]
