from .layer import MoE
from .sharded_moe import (moe_layer_ragged, moe_layer_ragged_ep,
                          resolve_grouped_params, topk_routing)

__all__ = ["MoE", "moe_layer_ragged", "moe_layer_ragged_ep",
           "resolve_grouped_params", "topk_routing"]
