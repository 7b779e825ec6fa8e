"""Serving layer of the port: the streaming CascadeSession engine (request
lifecycle with deadlines, flush policy, admission control, degraded
modes, retry / bisection / circuit breaker), the real-time SessionPump
(wall-clock continuous batching, thread-safe submit, blocking futures),
the multi-replica ReplicaRouter (least-loaded placement, global
admission, breaker-driven failover with probe re-admission; replicas of
one card on their own CUDA streams), the CascadeServer compatibility shim
and the neural final stage, request batching with a page-locked
transfer-buffer pool, the seeded fault injectors (executor and checkpoint
file IO), and the open-loop load generators (virtual-clock DES, single-
and multi-replica, + wall-clock).
The LLM engine is `serving.engine`."""

from repro_torch.serving.batching import (RankRequest, RankResponse,
                                          RequestBatcher, TransferBufferPool,
                                          pack_requests)
from repro_torch.serving.cascade_server import CascadeServer, NeuralScorer
from repro_torch.serving.faults import (CorruptOutput, FaultConfig,
                                        FaultInjector, FsFaultConfig,
                                        FsFaultInjector, InjectedFault,
                                        PoisonFault, TransientFault)
from repro_torch.serving.loadgen import (OpenLoopResult, run_open_loop,
                                         run_open_loop_router)
from repro_torch.serving.pump import (SessionPump, WallClockResult,
                                      run_wall_clock)
from repro_torch.serving.router import (ReplicaRouter, RouterConfig,
                                        make_replicas)
from repro_torch.serving.session import (CascadeSession, DegradePolicy,
                                         FlushPolicy, QueueFull, RankFuture,
                                         RetryPolicy, ServingConfig)

__all__ = ["CascadeServer", "CascadeSession", "CorruptOutput",
           "DegradePolicy", "FaultConfig", "FaultInjector", "FlushPolicy",
           "FsFaultConfig", "FsFaultInjector",
           "InjectedFault", "NeuralScorer", "OpenLoopResult", "PoisonFault",
           "QueueFull", "RankFuture", "RankRequest", "RankResponse",
           "ReplicaRouter", "RequestBatcher", "RetryPolicy", "RouterConfig",
           "ServingConfig", "SessionPump", "TransferBufferPool",
           "TransientFault", "WallClockResult", "make_replicas",
           "pack_requests", "run_open_loop", "run_open_loop_router",
           "run_wall_clock"]
