#
# Estimator-wide checkpoint/resume: the port of spark_rapids_ml_tpu/
# resilience/checkpoint.py.  Every iterative solver loop (the host
# L-BFGS/OWL-QN of ops/lbfgs.py, in memory and epoch-streaming, the FISTA
# loop of ops/linear.py, the stepwise KMeans of ops/kmeans.py and the
# epoch-streaming Lloyd of streaming.py) saves its state after each
# iteration when the `checkpoint_dir` conf is set, and a fit killed at
# iteration k resumes at k.
#
# The contract is the JAX package's, file for file: the name is
# `{kind}-{sha1(tag)[:16]}.npz` of the solver's content tag, the npz holds
# the tag beside the state and a load refuses a file whose tag differs, a
# save writes a tmp file and `os.replace`s it, and stale tmp files are
# swept.  So a checkpoint written by either package resumes in the other.
# The writer is rank 0 of `torch.distributed` when it is initialized, else
# the process.
#
from __future__ import annotations

import os
from typing import Dict, Optional

from ..config import get_config
from ..utils import get_logger
from . import metrics

logger = get_logger("spark_rapids_ml_torch.resilience")

# a *.tmp.npz younger than this may be a concurrent save between its savez
# and its os.replace; an older one is a crash's leftover
_TMP_SWEEP_AGE_S = 60.0


def sweep_orphaned_tmps(ckpt_dir: str) -> int:
    """Remove `*.tmp.npz` files older than `_TMP_SWEEP_AGE_S` (a crash
    between `np.savez` and `os.replace` leaves one behind); writer only.
    Returns how many were removed."""
    if not ckpt_dir or not _is_writer():
        return 0
    import glob
    import time

    removed = 0
    for tmp in glob.glob(os.path.join(ckpt_dir, "*.tmp.npz")):
        try:
            if time.time() - os.path.getmtime(tmp) >= _TMP_SWEEP_AGE_S:
                os.remove(tmp)
                removed += 1
        except OSError:
            continue  # another sweeper or a racing writer got there first
    if removed:
        logger.info(f"Swept {removed} orphaned checkpoint tmp file(s) from {ckpt_dir}")
    return removed


def resolve_checkpoint_dir(streaming: bool = False) -> str:
    """The checkpoint directory in force; empty means off.  The older
    `streaming_checkpoint_dir` applies to the streamed fits only
    (`streaming=True`).  Resolving sweeps orphaned tmp files."""
    d = get_config("checkpoint_dir")
    if not d and streaming:
        d = get_config("streaming_checkpoint_dir")
    d = str(d or "")
    if d and os.path.isdir(d):
        sweep_orphaned_tmps(d)
    return d


def checkpoint_file_for(ckpt_dir: str, tag: str) -> str:
    """The checkpoint file of a solver's content tag: `{kind}-{hash}.npz`,
    kind the tag's first `|` field, hash the first 16 hex digits of the
    tag's sha1.  Nothing per process enters the name, so a restarted fit
    finds its file."""
    import hashlib

    h = hashlib.sha1(tag.encode()).hexdigest()[:16]
    kind = tag.split("|", 1)[0]
    return os.path.join(ckpt_dir, f"{kind}-{h}.npz")


def _is_writer() -> bool:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except ImportError:  # pragma: no cover
        pass
    return True


def save_checkpoint(path: str, tag: str, state: Dict[str, object]) -> None:
    """Write `state` ({name: array-like}) under `tag`, atomically; other
    ranks do nothing."""
    if not path or not _is_writer():
        return
    import numpy as np

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, tag=np.asarray(tag), **{k: np.asarray(v) for k, v in state.items()})
    os.replace(tmp, path)
    metrics.inc("checkpoint_saves_total")


def load_checkpoint(path: str, tag: str) -> Optional[Dict[str, object]]:
    """The state saved at `path`, if the file exists and its tag is `tag`;
    a file of another fit warns and gives None."""
    if not path or not os.path.exists(path):
        return None
    import numpy as np

    with np.load(path, allow_pickle=False) as z:
        state = {k: z[k] for k in z.files}
    if str(state.pop("tag", "")) != tag:
        import warnings

        warnings.warn(f"Ignoring checkpoint {path}: it belongs to a different fit "
                      "(tag mismatch)")
        return None
    metrics.inc("checkpoint_resumes_total")
    return state


def clear_checkpoint(path: str) -> None:
    """Remove a finished fit's checkpoint (writer only; a missing file is
    fine)."""
    if not path or not _is_writer():
        return
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
