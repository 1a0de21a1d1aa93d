"""AggregaThor on PyTorch and CUDA: Byzantine-resilient SGD for one NVIDIA GPU.

The PyTorch counterpart of the JAX package ``aggregathor_tpu``, laid out as
its mirror so each module finds its twin under the same name:

- ``core``     flatten/inflate in the JAX coordinate order, optax-formula
               optimizers and schedules, the train state
- ``gars``     the GAR registry and the robust rules (average, krum, median,
               averaged-median, bulyan, trimmed-mean)
- ``ops``      hand-written CUDA kernels (``ops/csrc``) for the GAR hot path,
               each beside its plain PyTorch version
- ``models``   experiments (cnnet, mnist), numpy input pipelines, host
               preprocessing and the flax -> torch weight bridge
- ``parallel`` the flat robust engine on one device, and the attacks
- ``obs``      the evaluation TSV, checkpoints, summaries, the flight
               recorder, the metrics plane and the run journal
- ``guardian`` the in-step health probe, the divergence watchdog and the
               escalation ladder
- ``cli``      the training runner

Every entry point runs on CUDA unless the caller asks for the CPU
(``--device cpu`` / ``device="cpu"``); without a GPU it raises instead of
falling back.  The package imports ``torch`` and never JAX.
"""

__version__ = "0.1.0"
