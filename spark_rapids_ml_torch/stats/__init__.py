#
# spark_rapids_ml_torch.stats: the one-pass statistics of the port (the JAX
# package's stats/): statistic programs registered in `STAT_PROGRAMS`
# (programs.py), an engine that runs any set of them in ONE pass over an
# in-memory batch or a parquet file (engine.py, through the chunk cache),
# mergeable sketch state (sketches.py), and the `Summarizer` / `describe()`
# surface (summarizer.py).
#
from .engine import STAT_METRICS, iter_chunk_accs, run_program, run_programs
from .programs import (
    STAT_PROGRAMS,
    Field,
    StatProgram,
    get_program,
    merge_accs,
    register_program,
)
from .summarizer import SUPPORTED_METRICS, Summarizer, describe, summarize

__all__ = [
    "Field",
    "STAT_METRICS",
    "STAT_PROGRAMS",
    "SUPPORTED_METRICS",
    "StatProgram",
    "Summarizer",
    "describe",
    "get_program",
    "iter_chunk_accs",
    "merge_accs",
    "register_program",
    "run_program",
    "run_programs",
    "summarize",
]
