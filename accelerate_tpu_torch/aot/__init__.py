"""Compile management: the persistent store of programs and kernel
libraries, the warm start, and shape auto-bucketing.

Counterpart of :mod:`accelerate_tpu.aot`. The port runs eager PyTorch; what
it compiles is its hand-written CUDA kernels, with ``nvcc``, at a
program's first call. Three coupled pieces:

* :class:`ExecutableStore` / :func:`configure_persistent_cache`: the
  persistence layer, a content-keyed store of program records and of the
  kernel libraries they need, and a process-wide kernel library directory
  that outlives the process;
* :class:`ProgramCache`: the shared compile-or-fetch front end
  (``Accelerator.build_train_step`` under ``CompileKwargs``, the
  ``ServingEngine``'s prefill and decode tick, and the ``compile-cache``
  command all route through it), with ``compile_cache_*`` telemetry on
  every hit, miss and deserialize;
* :class:`ShapeBucketer` / :func:`pad_batch_tree`: pad ragged batch and
  sequence dims to a learned bucket set, so a ragged stream runs a bounded
  set of input signatures and the recompile watchdog stays silent.
"""

from .bucketing import ShapeBucketer, next_pow2, pad_batch_tree, round_up_to
from .cache import (
    CorruptEntryError,
    ExecutableStore,
    StaleEntryError,
    backend_descriptor,
    configure_persistent_cache,
    content_key,
    deserialize_compiled,
    resolve_cache_dir,
    serialize_compiled,
)
from .program_cache import ProgramCache, default_program_cache

__all__ = [
    "CorruptEntryError",
    "ExecutableStore",
    "ProgramCache",
    "ShapeBucketer",
    "StaleEntryError",
    "backend_descriptor",
    "configure_persistent_cache",
    "content_key",
    "default_program_cache",
    "deserialize_compiled",
    "next_pow2",
    "pad_batch_tree",
    "resolve_cache_dir",
    "round_up_to",
    "serialize_compiled",
]
