"""Preemption: a graceful stop on a signal, the state parked, a requeue.

Counterpart of ``oktopk_tpu/train/preemption.py`` (the reference's
BERT/bert/main_bert.py:73-203): SIGINT, SIGTERM and SIGUSR2 ask for a
clean stop, SIGUSR1 for a stop and a requeue; the CLIs poll
``should_stop`` between steps and run ``epilogue`` on the way out, which
drains the asynchronous checkpointer, parks the train state on rank 0
under ``<state dir>/<job id>.msgpack.d/`` (the JAX package's checkpoint
file, ``train/checkpoint.py``), issues ``scontrol requeue`` when asked
and returns exit code 3; a run that completes clears its parked state
and returns 0.

The state directory is ``$OKTOPK_STATE_DIR``, else
``~/.interrupted_states``, read when a function runs (not at import).
The job id is an explicit argument, else ``$SLURM_JOBID``, else
``$OKTOPK_RUN_ID``, else ``"local"``.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import threading
from typing import Any, Callable, Iterable, Optional, Union


def default_state_dir() -> str:
    return os.environ.get("OKTOPK_STATE_DIR",
                          os.path.expanduser("~/.interrupted_states"))


class PreemptionHandler:
    """Signal-driven stop and requeue flags: ``exit_signals`` ask for a
    clean stop, ``requeue_signals`` also for ``scontrol requeue``."""

    def __init__(self,
                 exit_signals: Iterable[int] = (signal.SIGINT,
                                                signal.SIGTERM,
                                                signal.SIGUSR2),
                 requeue_signals: Iterable[int] = (signal.SIGUSR1,)):
        self._stop = threading.Event()
        self._requeue = threading.Event()
        self._prev = {}
        for s in exit_signals:
            self._prev[s] = signal.signal(s, self._on_exit_signal)
        for s in requeue_signals:
            self._prev[s] = signal.signal(s, self._on_requeue_signal)

    def _on_exit_signal(self, signum, frame):
        self._stop.set()

    def _on_requeue_signal(self, signum, frame):
        self._requeue.set()
        self._stop.set()

    def request_stop(self) -> None:
        """Stop as an exit signal would (a process of a multi-process run
        that stopped because another rank was signalled)."""
        self._stop.set()

    def should_stop(self) -> bool:
        return self._stop.is_set()

    @property
    def requeue_requested(self) -> bool:
        return self._requeue.is_set()

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()


def interrupted_state_path(state_dir: Optional[str] = None,
                           job_id: Optional[str] = None) -> str:
    """``<state_dir>/<job id>.msgpack``; the parked checkpoints live in
    the directory of that name plus ``.d``."""
    jid = (job_id or os.environ.get("SLURM_JOBID")
           or os.environ.get("OKTOPK_RUN_ID") or "local")
    return os.path.join(state_dir or default_state_dir(), f"{jid}.msgpack")


def _parked_dir(state_dir, job_id) -> str:
    return interrupted_state_path(state_dir, job_id) + ".d"


def save_interrupted_state(state, step: int,
                           state_dir: Optional[str] = None,
                           job_id: Optional[str] = None,
                           extra: Optional[dict] = None) -> str:
    """Park the whole train state (a ``DistTrainState`` state dict) for a
    requeued restart; returns the checkpoint's path."""
    from oktopk_tpu_torch.train.checkpoint import save_checkpoint

    sub = _parked_dir(state_dir, job_id)
    os.makedirs(os.path.dirname(sub), exist_ok=True)
    return save_checkpoint(sub, state, step, extra=extra)


def load_interrupted_state(state_template,
                           state_dir: Optional[str] = None,
                           job_id: Optional[str] = None):
    """(state, step) of a parked run, or None when nothing is parked."""
    from oktopk_tpu_torch.train.checkpoint import restore_checkpoint

    sub = _parked_dir(state_dir, job_id)
    if not os.path.isdir(sub):
        return None
    try:
        return restore_checkpoint(sub, state_template)
    except FileNotFoundError:
        return None


def clear_interrupted_state(state_dir: Optional[str] = None,
                            job_id: Optional[str] = None) -> None:
    shutil.rmtree(_parked_dir(state_dir, job_id), ignore_errors=True)


def epilogue(state: Union[Any, Callable[[], Any]], last_step: int,
             preempt: Optional[PreemptionHandler], logger, rank: int = 0,
             completed: bool = False, state_dir: Optional[str] = None,
             extra: Optional[dict] = None, checkpointer=None) -> int:
    """The CLIs' exit path. The checkpointer (a
    ``durable.AsyncCheckpointer`` or None) is drained first, whatever
    the reason. If ``preempt`` fired before the run completed: park the
    state (rank 0 writes), requeue when asked, and return 3. Otherwise
    clear this job's parked state (rank 0) and return 0.

    ``state`` is the state dict, or a function that makes it; across
    processes making it is a collective, so every rank calls the
    epilogue and the function runs on every rank."""
    if checkpointer is not None:
        if not checkpointer.drain(timeout=300.0):
            logger.warning("async checkpointer failed to drain before "
                           "exit; a queued save may be lost")
    if preempt is not None and preempt.should_stop() and not completed:
        tree = state() if callable(state) else state
        if rank == 0:
            path = save_interrupted_state(tree, last_step,
                                          state_dir=state_dir, extra=extra)
            logger.info("preempted @ step %d: state parked at %s",
                        last_step, path)
        if preempt.requeue_requested and requeue_job(rank=rank):
            logger.info("requeue issued")
        return 3
    if preempt is not None and rank == 0:
        clear_interrupted_state(state_dir=state_dir)
    return 0


def requeue_job(rank: int = 0, job_id: Optional[str] = None,
                runner=subprocess.run) -> bool:
    """``scontrol requeue $SLURM_JOBID`` from rank 0 (``runner`` runs
    the command). Returns True if the requeue was issued."""
    jid = job_id or os.environ.get("SLURM_JOBID")
    if rank != 0 or not jid:
        return False
    try:
        runner(["scontrol", "requeue", jid], check=True, timeout=60)
        return True
    except Exception:
        return False
