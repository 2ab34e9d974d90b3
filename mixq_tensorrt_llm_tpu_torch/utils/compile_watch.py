"""Process-global count of programs made, counterpart of
utils/compile_watch.py.

The serving contract is that serving makes no program: ``Executor.warmup``
makes every program the serving loop can reach, and
``Executor.compiles_since_warmup`` shows whether a serving shape slipped
past it. The JAX package counts XLA compilations; the port's programs are

- each decode rung's first use (a captured CUDA graph on the card; on the
  CPU the same bookkeeping, run eagerly), noted by the Executor;
- each beam program's first use (runtime/beam.py: a prefill or per-step
  function memoized by key, and each BeamEngine's bursts, one CUDA graph a
  key on the card);
- each nvcc build of a kernel library (``ops/_build.build``).

``cache_hit_count`` counts kernel libraries loaded from ``build/kernels/``
that this process did not build: the counterpart of a persistent-cache
load.
"""

from __future__ import annotations

_programs = [0]
_cache_hits = [0]


def note_program() -> None:
    _programs[0] += 1


def note_cache_hit() -> None:
    _cache_hits[0] += 1


def compile_count() -> int:
    """Programs made in this process (monotone)."""
    return _programs[0]


def cache_hit_count() -> int:
    """Kernel libraries loaded without a build in this process."""
    return _cache_hits[0]
