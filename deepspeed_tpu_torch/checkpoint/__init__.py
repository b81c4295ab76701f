from .universal import (consolidate_to_fp32, ds_to_universal,
                        inspect_checkpoint, load_consolidated,
                        load_universal_param)

__all__ = ["consolidate_to_fp32", "ds_to_universal", "inspect_checkpoint",
           "load_consolidated", "load_universal_param"]
