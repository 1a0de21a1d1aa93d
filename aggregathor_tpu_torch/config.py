"""Static configuration defaults.

Mirrors the reference's tunable defaults (reference: config.py:42-66) minus the
parameter-server job names, which have no equivalent in the single-controller
SPMD design (there is no PS process; the GAR reduction point lives inside the
jitted step function).
"""

# Training (reference: config.py:47-51)
default_max_step = 10000
default_learning_rate = 1e-3
default_end_learning_rate = 1e-4
default_decay_step = 10000
default_decay_rate = 0.96

# Evaluation / checkpointing / summaries (reference: config.py:54-61)
default_evaluation_file_name = "eval"
default_evaluation_delta = -1
default_evaluation_period = 10.0
default_checkpoint_base_name = "model"
default_checkpoint_delta = -1
default_checkpoint_period = 120.0
default_summary_delta = -1
default_summary_period = 30.0

# Delay in the polling loop of the eval/checkpoint/summary daemon threads
# (reference: config.py:66)
thread_idle_delay = 1.0

# Mesh axis names used throughout the parallel engine
worker_axis = "worker"   # data-parallel Byzantine-worker axis
pipe_axis = "pipe"       # pipeline-parallel stage axis inside each worker
model_axis = "model"     # tensor-parallel axis inside each stage; sequence
                         # parallelism (ring attention / Megatron-SP gathers)
                         # and expert parallelism (MoE all_to_all) ride this
                         # same axis in different ops, the standard TPU layout
