from .blocked_allocator import BlockedAllocator
from .ragged import DSSequenceDescriptor, DSStateManager, RaggedBatchWrapper
from .prefix_cache import PrefixCache, PrefixMatch
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from . import kv_transfer
from .replica import Replica, ReplicaDead
from .router import DeadlineExceeded, Overloaded, Router, RouterConfig

__all__ = ["BlockedAllocator", "InferenceEngineV2",
           "RaggedInferenceEngineConfig", "DSSequenceDescriptor",
           "DSStateManager", "RaggedBatchWrapper", "PrefixCache",
           "PrefixMatch", "kv_transfer", "Replica",
           "ReplicaDead", "Router", "RouterConfig", "Overloaded",
           "DeadlineExceeded"]
