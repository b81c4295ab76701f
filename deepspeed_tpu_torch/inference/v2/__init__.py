from .blocked_allocator import BlockedAllocator
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from .ragged import DSSequenceDescriptor, DSStateManager, RaggedBatchWrapper

__all__ = ["BlockedAllocator", "InferenceEngineV2",
           "RaggedInferenceEngineConfig", "DSSequenceDescriptor",
           "DSStateManager", "RaggedBatchWrapper"]
