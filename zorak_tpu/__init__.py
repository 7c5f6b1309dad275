"""zorak_tpu — accelerator-native audio plugin platform (JAX/XLA).

A ground-up JAX/XLA/Pallas rebuild of the capabilities of
ZorakAudio/ZorakAudio-Experimental-Plugins (reference mounted read-only at
/root/reference): a JSFX (EEL2-dialect) frontend, a CPU golden shadow
runtime, JAX lowerings of the per-sample DSP to time-parallel device programs,
an offline render engine, comm/gmem services, and a null-test verification
harness.

Layers (see SURVEY.md for the reference layer map this mirrors):
  frontend/   JSFX lexer/parser/sections/directives  (ref: dsp_jsfx_aot.py:91-982)
  ir/         symbol model, user-fn lowering, capability analyses
  semantics/  the EEL2 numeric contract shared by every backend
  shadow/     CPU golden reference executors (Python + generated C)
  lowering/   AST -> JAX (general scan engine + time-vectorizing specializer)
  kernels/    STFT and convolution pipelines in plain jnp
  runtime/    offline render engine, WAV io, oversampling, file slots
  comm/       message bus + gmem (block-synchronous, in-process/HBM)
  parallel/   vmap/shard_map batch scale-out over files x instances
  verify/     null-test harness (audio eps 1e-5, scalar eps 1e-8)
  catalog/    plugin discovery (leaf plugin.json schema)
"""

__version__ = "0.1.0"

# EEL2 is a double-typed language; the whole framework runs with x64 enabled.
import jax as _jax

_jax.config.update("jax_enable_x64", True)
