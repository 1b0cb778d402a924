"""Failure detection + elastic restart machinery for long training runs.

SURVEY.md §5 scopes the reference's failure story as "none — restart by
hand" (its fit loop has no checkpoint cadence, preemption handling, or
divergence detection; DeepModel.py:141-228). This module supplies the
production pieces the TPU side needs, designed around the facts that

- TrainState already carries params + optimizer moments + step + rng, so
  a checkpoint IS an exact resume point (moment-exact restore is tested
  in tests/test_training.py), and
- the global step count uniquely locates a run inside an epoch when the
  per-epoch shuffle seed is a deterministic function of the epoch — so a
  mid-epoch restore can regenerate the SAME index matrix and skip the
  already-trained prefix, making resume bit-exact rather than
  epoch-replaying.

Pieces:

- ``Resilience``: periodic checkpointing (step and/or epoch cadence) with
  bounded retention, a crash-safe LATEST pointer (tmp + atomic rename),
  preemption-signal capture (TPU maintenance events surface as SIGTERM on
  the VM) that checkpoints at the next step boundary and raises
  ``Preempted``, and non-finite-loss detection that restores the last
  good checkpoint and raises ``TrainingDiverged``.
- ``Trainer.fit(..., resilience=...)`` drives it (training/trainer.py).

Checkpoints are plain ``ckpt.save_checkpoint`` directories named by
global step, so any of them also serves ``Trainer.restore`` / serving.

Scope: integrated with ``Trainer.fit`` (and ``ShardedTrainer`` — Orbax
checkpoints the sharded TrainState; restore re-places shardings).
``fit_stream`` is not step-resumable yet (chunk sources aren't
replayable mid-chunk); wrap it with per-chunk ``save()`` calls instead.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import signal as _signal

log = logging.getLogger(__name__)

LATEST_FILE = "LATEST.json"


class Preempted(RuntimeError):
    """Raised by fit() after a preemption signal was captured AND the
    state was checkpointed; the process should exit and be rescheduled."""


class TrainingDiverged(RuntimeError):
    """Raised when a non-finite loss is detected; the trainer's state has
    been rolled back to the last good checkpoint (if any)."""


class Resilience:
    """Checkpoint cadence + failure handling policy for Trainer.fit.

    Parameters
    ----------
    directory: checkpoint root; subdirectories ``step_<N>`` accumulate.
    every_steps: checkpoint every N optimizer steps (None = epoch-only).
    every_epochs: checkpoint every N completed epochs (default 1).
    keep: how many checkpoints to retain (oldest pruned first).
    preempt_signals: signals that request "checkpoint then stop"; handlers
        are installed during fit() and restored after. Default SIGTERM —
        what TPU-VM maintenance/preemption delivers.
    halt_on_nonfinite: detect NaN/Inf epoch loss, roll back to the last
        good checkpoint, raise TrainingDiverged.
    """

    def __init__(self, directory, every_steps=None, every_epochs=1, keep=2,
                 preempt_signals=(_signal.SIGTERM,), halt_on_nonfinite=True):
        self.directory = os.path.abspath(str(directory))
        self.every_steps = every_steps
        self.every_epochs = every_epochs
        self.keep = int(keep)
        self.preempt_signals = tuple(preempt_signals)
        self.halt_on_nonfinite = bool(halt_on_nonfinite)
        self._preempted = False
        self._prev_handlers = {}
        self._last_saved_step = -1

    # -- signal plumbing ---------------------------------------------------
    def _on_signal(self, signum, frame):
        log.warning("Resilience: captured signal %s — will checkpoint at "
                    "the next step boundary and stop", signum)
        self._preempted = True

    def install(self):
        for sig in self.preempt_signals:
            self._prev_handlers[sig] = _signal.signal(sig, self._on_signal)

    def uninstall(self):
        for sig, prev in self._prev_handlers.items():
            _signal.signal(sig, prev)
        self._prev_handlers = {}

    @property
    def preempted(self) -> bool:
        return self._preempted

    # -- checkpoint store --------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):010d}")

    def latest(self):
        """(path, meta dict) of the newest complete checkpoint, or None."""
        marker = os.path.join(self.directory, LATEST_FILE)
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            meta = json.load(f)
        path = os.path.join(self.directory, meta["name"])
        return (path, meta) if os.path.isdir(path) else None

    def save(self, trainer, step: int, epoch: int, extra: dict | None = None):
        """Checkpoint ``trainer`` at global ``step``; atomic LATEST update
        then retention pruning. ``extra`` merges into the LATEST metadata
        (fit_stream records its {"stream": {epoch, chunk, batch}} resume
        position through it)."""
        if step == self._last_saved_step:
            return  # already on disk (e.g. epoch boundary after step save)
        path = self._step_dir(step)
        trainer.save(path)
        meta = {"name": os.path.basename(path), "step": int(step),
                "epoch": int(epoch)}
        if extra:
            meta.update(extra)
        tmp = os.path.join(self.directory, LATEST_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.directory, LATEST_FILE))
        self._last_saved_step = int(step)
        self._prune()

    def _prune(self):
        kept = sorted(
            d for d in os.listdir(self.directory)
            if d.startswith("step_")
            and os.path.isdir(os.path.join(self.directory, d))
        )
        for d in kept[: max(0, len(kept) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def resume(self, trainer):
        """Restore the newest checkpoint into ``trainer`` if one exists.
        Returns the restored meta dict or None."""
        found = self.latest()
        if found is None:
            return None
        path, meta = found
        trainer.restore(path)
        self._last_saved_step = int(meta["step"])
        log.info("Resilience: resumed from %s (step %d, epoch %d)",
                 path, meta["step"], meta["epoch"])
        return meta

    # -- fit-loop hooks ----------------------------------------------------
    def step_boundary(self, trainer, step: int, epoch: int,
                      extra: dict | None = None):
        """Called between optimizer steps; handles cadence + preemption."""
        if self._preempted:
            self.save(trainer, step, epoch, extra)
            raise Preempted(
                f"preemption signal captured; state checkpointed at "
                f"step {step} in {self.directory}"
            )
        if self.every_steps and step > 0 and step % self.every_steps == 0:
            self.save(trainer, step, epoch, extra)

    def epoch_boundary(self, trainer, step: int, epoch: int, mean_loss: float,
                       extra: dict | None = None):
        """Called after each epoch's eval-ready loss is known."""
        import math

        if self.halt_on_nonfinite and not math.isfinite(mean_loss):
            found = self.latest()
            if found is not None:
                trainer.restore(found[0])
                raise TrainingDiverged(
                    f"non-finite epoch loss {mean_loss} at epoch {epoch}; "
                    f"state rolled back to {found[0]}"
                )
            raise TrainingDiverged(
                f"non-finite epoch loss {mean_loss} at epoch {epoch}; "
                "no checkpoint to roll back to"
            )
        if self._preempted:
            self.save(trainer, step, epoch, extra)
            raise Preempted(
                f"preemption signal captured; state checkpointed at "
                f"epoch {epoch} in {self.directory}"
            )
        if self.every_epochs and epoch % self.every_epochs == 0:
            self.save(trainer, step, epoch, extra)
