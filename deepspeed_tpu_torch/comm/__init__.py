from .comm import (all_reduce, reduce_scatter, all_gather, all_to_all,
                   exchange,
                   broadcast, ppermute, ppermute_start, send_forward,
                   send_backward, axis_index, init_distributed,
                   is_initialized, get_rank, get_world_size,
                   get_local_device_count, get_backend,
                   ring_exchange_bytes,
                   allgather_bytes, barrier, configure, log_summary)
from .logging import CommsLogger, get_comms_logger
from .quantized import (quantized_reduce_scatter, quantized_all_gather,
                        dcn_precision_clamp, all_to_all_quant_reduce)
