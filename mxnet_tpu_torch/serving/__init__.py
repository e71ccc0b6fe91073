"""Serving (counterpart of `mxnet_tpu.serving`): predict serving (a
dynamic micro-batcher over bucketed `Predictor`s) and generation serving
(paged-KV continuous batching), behind one HTTP server, in process or
through a supervised `ReplicaPool` of worker processes, whose replica
count an `Autoscaler` can steer from the SLO verdicts."""
from .autoscaler import Autoscaler
from .batcher import (DeadlineExceededError, DrainingError, DynamicBatcher,
                      MemoryBudgetError, ModelUnavailableError,
                      OverloadedError, QueueFullError, ServeRequest,
                      ServingError, bucket_for, drain_timeout_s, pad_batch,
                      power_of_two_buckets)
from .generate import (GenerateScheduler, GenRequest, KVPageAllocator,
                       ServedLM, TransformerLMEngine, load_lm, save_lm)
from .model_repository import ModelRepository, ServedModel, build_runner
from .replica_pool import ReplicaPool
from .server import ServingServer

__all__ = ["Autoscaler", "ServingError", "QueueFullError",
           "DeadlineExceededError",
           "ModelUnavailableError", "DrainingError", "OverloadedError",
           "MemoryBudgetError", "drain_timeout_s", "power_of_two_buckets",
           "bucket_for", "pad_batch", "ServeRequest", "DynamicBatcher", "KVPageAllocator",
           "GenRequest", "GenerateScheduler", "TransformerLMEngine",
           "ServedLM", "save_lm", "load_lm", "ServedModel", "build_runner",
           "ModelRepository", "ReplicaPool", "ServingServer"]
