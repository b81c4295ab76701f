from .layer import MoE
from .sharded_moe import (TopKGate, moe_layer, moe_layer_ragged,
                          moe_layer_ragged_ep, resolve_grouped_params,
                          top1gating, top2gating, topk_routing)

__all__ = ["MoE", "TopKGate", "moe_layer", "moe_layer_ragged",
           "moe_layer_ragged_ep", "resolve_grouped_params", "top1gating",
           "top2gating", "topk_routing"]
