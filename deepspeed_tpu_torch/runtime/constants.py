"""Config key names: own copy of the keys of
``deepspeed_tpu/runtime/constants.py`` (itself mirroring the reference's
``runtime/constants.py``) that the port's config reads."""

# Batch size triad (reference runtime/constants.py TRAIN_BATCH_SIZE et al.)
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

# Precision
FP16 = "fp16"
BF16 = "bf16"

# ZeRO
ZERO_OPTIMIZATION = "zero_optimization"

# Parallel topology (TPU-native extension; the reference takes mpu/ep_size
# through function args rather than config)
TENSOR_PARALLEL = "tensor_parallel"
PIPELINE = "pipeline"
SEQUENCE_PARALLEL_SIZE = "sequence_parallel_size"
EXPERT_PARALLEL_SIZE = "expert_parallel_size"

COMMS_LOGGER = "comms_logger"
MONITOR_CSV = "csv_monitor"

DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"
