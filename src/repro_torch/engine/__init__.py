"""Inference engine: bind params to a Plan and execute the planned graph,
serve it, or serve an LM.

``compile``/``InferenceSession`` (engine/session.py) is the front door —
plan, bind, specialize per batch size, ``save`` and ``load`` the
reference's version-5 artifact (``Session`` is its short alias); ``compile_model`` is the lower-level
bind-one-plan entry it rides on.  An LM name or ``LMConfig`` goes to
``compile_lm``/``LMSession`` (engine/lm_session.py): seq-bucketed prefill
and greedy decode.  ``params_from_numpy`` and ``lm_params_from_numpy``
(engine/weights.py) bring numpy parameters onto a device.

``AsyncServer`` (engine/serving.py) turns a session into a dynamic-batching
serving loop with deterministic, padding-based bucket execution, one CUDA
stream a worker, worker supervision (retries, restarts, hung-batch
watchdog), pluggable overload shedding and token streams of an LM session;
``engine/faults.py`` provides the deterministic fault injection the failure
paths are tested with; ``engine/supervision.py`` holds the pure decision
logic (heartbeats, stragglers, retry backoff, shed policies);
``engine/telemetry.py`` the bounded streaming statistics (size histograms,
P² quantile estimators); ``engine/traffic.py`` the bucket-set solvers,
priority classes and synthetic traces; and ``engine/fleet.py``
(``FleetServer``) multi-tenant hosting under a shared schedule database and
an LRU memory budget.
"""
from repro_torch.engine.executor import (CompiledModel, bind_params,
                                         compile_model)
from repro_torch.engine.faults import (DelayBatch, FailBatch, FaultInjector,
                                       InjectedFault, InjectedPredictError,
                                       InjectedWorkerCrash, KillWorker,
                                       corrupt_artifact, corrupt_file)
from repro_torch.engine.fleet import (DuplicateModelError, FleetServer,
                                      MemoryBudgetError, UnknownModelError)
from repro_torch.engine.lm_session import LMSession, compile_lm
from repro_torch.engine.serving import (AllWorkersUnhealthyError,
                                        AsyncServer, BatchPolicy,
                                        DeadlineExceededError,
                                        DynamicBatchPolicy, LoadShedError,
                                        QueueFullError, RequestTooLargeError,
                                        RetriesExhaustedError,
                                        ServerClosedError, ServingError,
                                        ServingStats, StreamRequest,
                                        TokenStream, WorkerCrashError,
                                        nearest_bucket, padded_predict)
from repro_torch.engine.session import (SESSION_DTYPES, ArtifactCorruptError,
                                        ArtifactError, InferenceSession,
                                        Session, UnverifiedArtifactWarning,
                                        compile)
from repro_torch.engine.supervision import (SHED_POLICIES, HeartbeatMonitor,
                                            RetryPolicy, StragglerMitigator,
                                            StragglerPolicy,
                                            choose_shed_victim)
from repro_torch.engine.telemetry import (P2Quantile, SizeHistogram,
                                          StreamingQuantiles)
from repro_torch.engine.traffic import (DEFAULT_PRIORITY, PRIORITY_CLASSES,
                                        TRACE_KINDS, TraceRequest,
                                        expected_catchup_tokens,
                                        expected_padded_waste, priority_rank,
                                        solve_buckets, solve_seq_buckets,
                                        synth_trace)
from repro_torch.engine.weights import lm_params_from_numpy, params_from_numpy

__all__ = ["AllWorkersUnhealthyError", "ArtifactCorruptError",
           "ArtifactError", "AsyncServer", "BatchPolicy", "CompiledModel",
           "DEFAULT_PRIORITY", "DeadlineExceededError", "DelayBatch",
           "DuplicateModelError", "DynamicBatchPolicy",
           "FailBatch", "FaultInjector", "FleetServer", "HeartbeatMonitor",
           "InferenceSession", "InjectedFault", "InjectedPredictError",
           "InjectedWorkerCrash", "KillWorker", "LMSession", "LoadShedError",
           "MemoryBudgetError", "P2Quantile", "PRIORITY_CLASSES",
           "QueueFullError", "RequestTooLargeError",
           "RetriesExhaustedError", "RetryPolicy", "SESSION_DTYPES",
           "SHED_POLICIES", "ServerClosedError", "ServingError",
           "ServingStats", "Session", "SizeHistogram", "StragglerMitigator",
           "StragglerPolicy", "StreamRequest", "StreamingQuantiles",
           "TRACE_KINDS", "TokenStream", "TraceRequest", "UnknownModelError",
           "UnverifiedArtifactWarning", "WorkerCrashError", "bind_params",
           "choose_shed_victim", "compile", "compile_lm", "compile_model",
           "corrupt_artifact", "corrupt_file", "expected_catchup_tokens",
           "expected_padded_waste", "lm_params_from_numpy",
           "nearest_bucket", "padded_predict", "params_from_numpy",
           "priority_rank", "solve_buckets", "solve_seq_buckets",
           "synth_trace"]
