"""Trainer: sklearn-style fit / predict / evaluate, streaming, checkpoints.

Counterpart of ``recman_tpu/training/trainer.py``: the dataset is encoded
once and lives on the device; a mini-batch is a device-side gather of a
shuffled index row; one optimizer is held for the whole run; the final
partial batch is padded to the batch size and masked. Eval during fit
defaults to training=False (``eval_in_training_mode=True`` keeps the
reference's dropout-in-eval quirk).

``fit(resilience=...)`` and ``fit_stream`` take a ``training.Resilience``
policy: periodic and preemption checkpoints (``save``/``restore``,
``ckpt/checkpoint.py``) and a bit-exact resume from LATEST. ``fit_stream``,
``predict_stream`` and ``evaluate_stream`` double-buffer encoded host
chunks (``data/streaming.py``) through the device. ``calibrate`` freezes
Dice's batch moments into the params before each eval.
"""

from __future__ import annotations

import contextlib
import logging
import warnings
from concurrent.futures import ThreadPoolExecutor
from time import time

import numpy as np
import torch

from ..config import BaseHyperParameters
from ..device import resolve_device
from .train_step import (
    TrainState,
    create_optimizer,
    init_state,
    make_eval_scan,
    make_eval_step,
    make_train_epoch,
    make_train_step,
    pack_dataset,
)

log = logging.getLogger(__name__)


def batch_indices(n: int, batch_size: int, shuffle_seed=None) -> np.ndarray:
    """(num_batches, batch_size) int32 row indices, -1-padded at the tail,
    in the order ``np.random.RandomState(shuffle_seed).permutation(n)``
    when a seed is given.

    num_batches is the reference's ``n // batch_size + 1``: a full final
    slice yields one extra all-padding batch."""
    order = np.arange(n)
    if shuffle_seed is not None:
        order = np.random.RandomState(shuffle_seed).permutation(n)
    num_batches = n // batch_size + 1
    padded = np.full((num_batches * batch_size,), -1, dtype=np.int32)
    padded[:n] = order
    return padded.reshape(num_batches, batch_size)


def _first_row(X):
    """The first row of a dataframe or of a column dict (the reference
    slices ``X[:1]``, which a dict does not take)."""
    if isinstance(X, dict):
        return {k: v[:1] for k, v in X.items()}
    return X[:1] if hasattr(X, "__getitem__") else None


class Trainer:
    """Drives a model. ``hparams`` needs learning_rate (a float or a
    schedule, ``training.lr_schedule``) and optimizer (a name of
    ``create_optimizer``'s menu or an optimizer object), as the
    reference's; everything model-specific lives in the model object.
    ``device``: default CUDA (raises without a GPU); pass ``device="cpu"``
    for the plain path.

    ``steps_per_dispatch``: > 1 groups consecutive steps
    (``make_train_step_unrolled``, or the stacked step when
    ``_stacked_active``). "auto" is 1: the reference's 16 on TPU amortises
    its per-dispatch latency, but an unrolled step here is the same Python
    loop, so grouping buys nothing. ``epoch_in_one_dispatch`` likewise runs
    the epoch's steps in one call of a loop."""

    def __init__(
        self,
        model,
        hparams: dict | None = None,
        metrics=(),
        epoch=10,
        batch_size=64,
        random_seed=2019,
        eval_in_training_mode=False,
        epoch_in_one_dispatch=False,
        steps_per_dispatch="auto",
        stacked_tables="auto",
        device=None,
    ):
        hp = hparams or {}
        self.device = resolve_device(device)
        self.model = model
        self.hparams = hp
        self.metrics = tuple(metrics)
        self.epoch = epoch
        self.batch_size = batch_size
        self.random_seed = random_seed
        self.eval_in_training_mode = eval_in_training_mode
        self.epoch_in_one_dispatch = epoch_in_one_dispatch
        self.steps_per_dispatch = 1 if steps_per_dispatch == "auto" else int(steps_per_dispatch)
        self._train_step_unrolled = None  # built on first use
        # stacked (T, V, k) table storage for the grouped-step loop
        # (ops.embedding.stacked_tables); "auto" = on where the fused
        # backward is active, True forces it, False disables it
        self.stacked_tables = stacked_tables
        self._train_step_stacked = None  # built on first use

        self.optimizer = create_optimizer(
            hp.get(BaseHyperParameters.Optimizer, "adam"),
            hp.get(BaseHyperParameters.LearningRate, 0.001),
        )
        self._train_step = make_train_step(model, self.optimizer)
        self._train_epoch = make_train_epoch(model, self.optimizer)
        self._eval_step = make_eval_step(model)
        self._eval_scan = make_eval_scan(model)
        self.state: TrainState = init_state(
            model, self.optimizer, torch.Generator().manual_seed(random_seed), device=self.device
        )

    # -- data plumbing -----------------------------------------------------
    def _to_device(self, X, y=None):
        """Dataframe -> encoded tensors on the device (a dict passes through
        as already encoded). Columns are packed by dtype (pack_dataset);
        returns (data, layout)."""
        data, layout = self._encode(X, y)
        return {k: torch.as_tensor(v).to(self.device) for k, v in data.items()}, layout

    def _encode(self, X, y=None):
        """``_to_device``'s host half: (packed numpy columns, layout)."""
        if isinstance(X, dict):
            data = dict(X)
            if y is not None:
                data["y"] = np.asarray(y, dtype=np.float32)
        else:
            data = self.model.feat_dict.transform(X, y)
        if "y" not in data:
            data["y"] = np.zeros(len(next(iter(data.values()))), dtype=np.float32)
        return pack_dataset(data)

    def _override(self):
        """Linear-tower weight-override vector, rebuilt from the live
        feature schema each call (so set_weights takes effect at once)."""
        linear = getattr(self.model, "linear", None)
        if linear is None:
            return None
        return torch.as_tensor(linear.override_vector()).to(self.device)

    def _idx(self, idx):
        return torch.as_tensor(idx, device=self.device)

    # -- public surface ----------------------------------------------------
    @property
    def params(self) -> dict:
        return self.state.params

    def predict(self, X, training=False, batch_number_to_show_progress=50):
        """Batched forward over all rows; ``training=True`` keeps dropout
        live, as the reference's in-fit eval does."""
        n = len(next(iter(X.values()))) if isinstance(X, dict) else len(X)
        data, layout = self._to_device(X)
        return self._predict_device(data, training, layout, n=n)

    def evaluate(self, X, y, training=False):
        """[metric(y, pred) for metric in metrics]."""
        pred = self.predict(X, training=training)
        y = np.asarray(y, dtype=np.float32)
        return [metric(y, pred) for metric in self.metrics]

    def fit_on_batch(self, data: dict, idx, layout=()):
        """One train step. Returns the loss as a device tensor (reading it
        would synchronise with the card every step; fit reads the epoch's
        losses once)."""
        self.state, loss = self._train_step(self.state, data, self._idx(idx), layout)
        return loss

    def fit_stream(self, chunks, epochs=None, shuffle_in_chunk=True, resilience=None):
        """Train over a stream of encoded host chunks ({name: array, 'y':
        ...} dicts, ``data.streaming``'s iterators) with double buffering:
        a prefetch thread reads and packs chunk c + 1 while the steps of
        chunk c run, then copies it to the device behind them, so the
        device holds at most two chunks whatever the dataset's size.

        ``chunks``: an iterable (one pass) or a zero-arg callable returning
        a fresh iterator (required when ``epochs`` > 1 or with
        ``resilience``). Rows shuffle within each chunk per epoch when
        ``shuffle_in_chunk``, with the seed ``random_seed + 7919 * epoch +
        chunk``. Returns self.

        The copies run on the prefetch thread's current stream, the
        default stream, which orders them before the steps that read them;
        a copy also waits there behind the steps already queued, so only
        the host's read, parse and pack overlap the steps, not the copy.

        ``resilience``: checkpoints record the stream position (epoch,
        chunk, batches done in the chunk) in LATEST.json; a resume restores
        the state and fast-forwards the chunk source to it, so the resumed
        run replays the remaining batches exactly (bit-exact, like fit's
        mid-epoch resume). The chunk factory's order must be deterministic.
        """
        epochs = self.epoch if epochs is None else epochs
        if not callable(chunks):
            assert epochs == 1 and resilience is None, (
                "a plain iterator can only be consumed once; pass a "
                "zero-arg callable for multi-epoch or resumable streams"
            )
            chunk_iter = chunks
            chunks = lambda: chunk_iter  # noqa: E731

        start_epoch, resume_chunk, resume_batch = 1, 0, 0
        steps_done = 0
        if resilience is not None:
            meta = resilience.resume(self)
            if meta is not None:
                steps_done = int(meta["step"])
                pos = meta.get("stream")
                if pos is None:
                    log.warning(
                        "Resilience: checkpoint has no stream position (written by fit()?); "
                        "restarting the stream from epoch %d chunk 0 with the restored state",
                        int(meta["epoch"]),
                    )
                    start_epoch = int(meta["epoch"])
                else:
                    start_epoch = int(pos["epoch"])
                    resume_chunk = int(pos["chunk"])
                    resume_batch = int(pos["batch"])
                    if start_epoch > epochs:
                        log.info("Resilience: stream run already complete at step %d",
                                 steps_done)
                        return self
            resilience.install()

        last_chunk = None
        try:
            for epoch in range(start_epoch, epochs + 1):
                it = iter(chunks())
                skip_chunks = resume_chunk if epoch == start_epoch else 0
                skip_batches = resume_batch if epoch == start_epoch else 0
                for _ in range(skip_chunks):
                    if next(it, None) is None:
                        break
                if skip_chunks:
                    log.info("Resilience: resuming stream epoch %d at chunk %d, batch %d",
                             epoch, skip_chunks, skip_batches)

                def prepare(c_i):
                    # the prefetch thread: read, pack and copy the next chunk
                    chunk = next(it, None)
                    if chunk is None:
                        return None
                    nonlocal last_chunk
                    last_chunk = chunk  # calibrate's sample
                    data, layout = self._to_device(chunk, chunk.get("y"))
                    n = int(len(next(iter(chunk.values()))))
                    seed = self.random_seed + 7919 * epoch + c_i if shuffle_in_chunk else None
                    return data, layout, self._idx(self._batch_index_matrix(n, shuffle_seed=seed))

                total, batches, c_i = 0.0, 0, skip_chunks
                with ThreadPoolExecutor(max_workers=1) as pool:
                    cur = prepare(c_i)
                    while self._chunk_ready(cur):
                        data, layout, idx = cur
                        offset = skip_batches if c_i == skip_chunks else 0
                        c_i += 1
                        fut = pool.submit(prepare, c_i)
                        losses = []
                        for i in range(offset, idx.shape[0]):
                            losses.append(self.fit_on_batch(data, idx[i], layout))
                            steps_done += 1
                            if resilience is not None:
                                resilience.step_boundary(
                                    self, steps_done, epoch,
                                    extra={"stream": {"epoch": epoch, "chunk": c_i - 1,
                                                      "batch": i + 1}},
                                )
                        # one read of the chunk's losses
                        total += float(torch.stack(losses).double().sum()) if losses else 0.0
                        batches += len(losses)
                        del data, losses
                        cur = fut.result()
                mean_loss = total / max(batches, 1)
                log.info("fit_stream epoch %d: %d chunks, %d batches, mean loss %.5f",
                         epoch, c_i, batches, mean_loss)
                if resilience is not None:
                    resilience.epoch_boundary(
                        self, steps_done, epoch, mean_loss,
                        extra={"stream": {"epoch": epoch + 1, "chunk": 0, "batch": 0}},
                    )
                if last_chunk is not None:
                    self.calibrate(last_chunk)
        finally:
            if resilience is not None:
                resilience.uninstall()
        return self

    def _chunk_ready(self, cur) -> bool:
        """Whether the stream loop has a chunk to run: ``cur`` is the
        prefetch thread's (data, layout, index matrix, ...) or None at the
        stream's end. Runs on the main thread (``ShardedTrainer`` checks
        the ranks' batch counts here)."""
        return cur is not None

    def predict_stream(self, chunks, training=False):
        """Batched forward over a stream of encoded host chunks ('y'
        allowed and ignored), double-buffered as in ``fit_stream``.
        Returns the (N,) predictions in stream order."""
        it = iter(chunks() if callable(chunks) else chunks)
        override = None if training else self._override()

        def prepare():
            chunk = next(it, None)
            if chunk is None:
                return None
            n = int(len(next(iter(chunk.values()))))
            data, layout = self._to_device({k: v for k, v in chunk.items() if k != "y"})
            return data, layout, self._idx(self._batch_index_matrix(n)), n

        out = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            cur = prepare()
            while self._chunk_ready(cur):
                data, layout, idx, n = cur
                fut = pool.submit(prepare)
                preds = self._eval_scan(self.state.params, data, idx, override, training, layout)
                out.append(self._unshard_preds(preds.cpu().numpy(), n))
                del data, preds
                cur = fut.result()
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def evaluate_stream(self, chunks, training=False):
        """[metric(y, pred)] over a chunk stream; chunks must carry 'y'."""
        ys = []
        it = iter(chunks() if callable(chunks) else chunks)

        def labelled():
            for chunk in it:
                ys.append(np.asarray(chunk["y"], dtype=np.float32))
                yield chunk

        ps = self.predict_stream(labelled(), training=training)
        y = np.concatenate(ys) if ys else np.zeros((0,), np.float32)
        return [metric(y, ps) for metric in self.metrics]

    def calibrate(self, X, max_rows=65536) -> bool:
        """Freeze Dice's normalization moments into the params (reference
        trainer.py:382-449).

        Dice normalizes with the batch's moments in training; inference
        reads the stored ``*_dice_mean_*`` / ``*_dice_var_*`` params, so
        that a prediction does not depend on which rows share its batch.
        This runs one training-mode forward under ``torch.no_grad()``, with
        no generator (dropout off), over the first ``max_rows`` rows of
        ``X`` (a dataframe or an encoded dict), and writes the moments it
        captured into the state's params. ``fit`` and ``fit_stream`` call it
        before each eval; call it yourself after driving ``fit_on_batch``.

        Returns True when the model has Dice moments and they were written.
        A model with Dice moments whose apply takes no ``moment_capture``
        warns and returns False: it would serve with the init moments."""
        has_dice = any("_dice_mean_" in k for k in self.state.params)
        if not getattr(self.model, "supports_moment_capture", False):
            if has_dice:
                warnings.warn(
                    f"{type(self.model).__name__} has Dice moment params but "
                    "does not support moment capture: training=False "
                    "eval/serving will use the untrained init moments "
                    "(mean=0, var=1). Thread moment_capture through apply() "
                    "and set supports_moment_capture=True.",
                    stacklevel=2,
                )
            return False
        if not has_dice:
            return False

        if isinstance(X, dict):
            data = {k: np.asarray(v)[:max_rows] for k, v in X.items()}
        else:
            Xs = X.iloc[:max_rows] if hasattr(X, "iloc") else X[:max_rows]
            data = self.model.feat_dict.transform(Xs)
        data.pop("y", None)
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in data.items()}
        captured = {}
        with torch.no_grad():
            self.model.apply(self.state.params, batch, training=True, generator=None,
                             moment_capture=captured)
        params = dict(self.state.params)
        params.update({k: v.to(torch.float32) for k, v in captured.items()})
        self.state = self.state._replace(params=params)
        return True

    def _eval_at_epoch(self, data_train, y_train, X_valid, y_valid, start_time, epoch,
                       layout=()):
        """Per-epoch train/valid metric log."""
        training = self.eval_in_training_mode
        train_pred = self._predict_device(data_train, training, layout, n=len(y_train))
        train_res = [m(y_train, train_pred) for m in self.metrics]
        valid_res = None
        if X_valid is not None and y_valid is not None:
            valid_res = self.evaluate(X_valid, y_valid, training=training)
            log.info(
                "[%d] train-result=%s, valid-result=%s [%.1f s]",
                epoch,
                [(str(m), round(r, 4)) for m, r in zip(self.metrics, train_res)],
                [(str(m), round(r, 4)) for m, r in zip(self.metrics, valid_res)],
                time() - start_time,
            )
        else:
            log.info(
                "[%d] train-result=%s [%.1f s]",
                epoch,
                [(str(m), round(r, 4)) for m, r in zip(self.metrics, train_res)],
                time() - start_time,
            )
        return train_res, valid_res

    def _batch_index_matrix(self, n: int, shuffle_seed=None) -> np.ndarray:
        return batch_indices(n, self.batch_size, shuffle_seed=shuffle_seed)

    def _stacked_active(self) -> bool:
        """Should fit's grouped-step loop run on stacked table storage?"""
        mode = self.stacked_tables
        if mode in (False, "off"):
            return False
        packed = getattr(self.model, "packed", None)
        eligible = packed is not None and packed.stackable() is not None
        if mode in (True, "on"):
            return eligible
        from ..ops.embedding import _fused_active

        return eligible and _fused_active(self.device)

    def _steps_per_epoch(self, n: int) -> int:
        """Rows of ``_batch_index_matrix(n)``."""
        return n // self.batch_size + 1

    def _predict_device(self, data: dict, training: bool, layout=(), n=None) -> np.ndarray:
        n = int(data["y"].shape[0]) if n is None else n
        idx = self._idx(self._batch_index_matrix(n))
        override = None if training else self._override()
        preds = self._eval_scan(self.state.params, data, idx, override, training, layout)
        return self._unshard_preds(preds.cpu().numpy(), n)

    def _unshard_preds(self, preds: np.ndarray, n: int) -> np.ndarray:
        """Flat eval output back to dataset row order (the identity on one
        device)."""
        return preds[:n]

    def _fit_grouped(self, data, idx, layout, step_done=None):
        """Steps in groups of ``steps_per_dispatch``, the non-divisible
        tail one step at a time; ``step_done(i)`` after the group or step
        that ends with row i. Stacked storage only without ``step_done``:
        a resilience checkpoint reads ``self.state`` between steps, so a
        resilient run keeps per-table storage."""
        from .train_step import (
            make_train_step_stacked,
            make_train_step_unrolled,
            stack_train_state,
            unstack_train_state,
        )

        u = self.steps_per_dispatch
        full = (idx.shape[0] // u) * u
        losses = []
        if step_done is None and self._stacked_active():
            if self._train_step_stacked is None:
                self._train_step_stacked = make_train_step_stacked(
                    self.model, self.optimizer, u, self.model.packed.stackable())
            sstate = stack_train_state(self.model, self.state)
            try:
                for s in range(0, full, u):
                    sstate, lvec = self._train_step_stacked(sstate, data, idx[s:s + u], layout)
                    losses.append(lvec)
            finally:
                self.state = unstack_train_state(self.model, sstate)
        else:
            if self._train_step_unrolled is None:
                self._train_step_unrolled = make_train_step_unrolled(
                    self.model, self.optimizer, u)
            for s in range(0, full, u):
                self.state, lvec = self._train_step_unrolled(self.state, data, idx[s:s + u], layout)
                losses.append(lvec)
                if step_done is not None:
                    step_done(s + u - 1)
        for i in range(full, idx.shape[0]):
            losses.append(self.fit_on_batch(data, idx[i], layout)[None])
            if step_done is not None:
                step_done(i)
        return torch.cat(losses)

    def fit(
        self,
        X_train,
        y_train,
        X_valid=None,
        y_valid=None,
        random_seed_for_mini_batch=True,
        tb_logger=None,
        epoch_callback=None,
        show_progress=False,
        batch_number_to_show_progress=50,
        resilience=None,
    ):
        """The reference's fit loop: epoch-0 eval (with an optional profiler
        trace), then per epoch a reshuffle (``np.random.randint(1, 2019)``
        as the seed, the reference's quirk, unless
        ``random_seed_for_mini_batch=False``), the steps, the eval, the TB
        log and the callback.

        ``resilience``: a ``training.Resilience`` policy: periodic and
        preemption checkpoints, a mid-epoch resume from LATEST, divergence
        rollback. It forces the deterministic per-epoch seed
        ``(random_seed + 104729 * epoch) % (2**31 - 1)``, so a restored
        step count regenerates the epoch's index matrix and the resume is
        bit-exact."""
        assert X_train is not None and y_train is not None
        try:
            import tqdm

            progress = tqdm.tqdm(desc="fit", total=self.epoch, disable=not show_progress)
        except ImportError:
            progress = contextlib.nullcontext()
            progress.update = lambda *a, **k: None

        if tb_logger is not None:
            tb_logger.configure_hparams(self.hparams, self.metrics)

        data, layout = self._to_device(X_train, y_train)
        y_np = np.asarray(y_train, dtype=np.float32)
        n = len(y_np)

        steps_per_epoch = self._steps_per_epoch(n)
        start_epoch, resume_offset = 1, 0
        if resilience is not None:
            meta = resilience.resume(self)
            if meta is not None:
                done = int(meta["step"])
                start_epoch = done // steps_per_epoch + 1
                resume_offset = done % steps_per_epoch
                if start_epoch > self.epoch and resume_offset == 0:
                    log.info("Resilience: run already complete at step %d", done)
                    return self
            resilience.install()

        try:
            if tb_logger is not None:
                tb_logger.trace_on(epoch=0)
            self.calibrate(X_train)
            eval_results = self._eval_at_epoch(data, y_np, X_valid, y_valid, time(), epoch=0,
                                               layout=layout)
            if tb_logger is not None:
                tb_logger.trace_off(epoch=0)
                tb_logger.log_params(epoch=0, eval_results=eval_results, metrics=self.metrics,
                                     variables=self._host_params())

            for epoch in range(start_epoch, self.epoch + 1):
                start_time = time()
                if resilience is not None:
                    # a restored step count regenerates this epoch's index matrix
                    seed = (self.random_seed + 104729 * epoch) % (2**31 - 1)
                elif random_seed_for_mini_batch:
                    seed = np.random.randint(1, 2019)  # reference DeepModel.py:183
                else:
                    seed = self.random_seed
                idx = self._idx(self._batch_index_matrix(n, shuffle_seed=seed))
                epoch_base = (epoch - 1) * steps_per_epoch
                offset = resume_offset if epoch == start_epoch else 0
                if offset:
                    idx = idx[offset:]
                    log.info("Resilience: resuming epoch %d at batch %d/%d",
                             epoch, offset, steps_per_epoch)

                step_done = None
                if resilience is not None:
                    def step_done(local_i, epoch=epoch, base=epoch_base + offset):
                        resilience.step_boundary(self, base + local_i + 1, epoch)

                if tb_logger is None and self.epoch_in_one_dispatch:
                    self.state, losses = self._train_epoch(self.state, data, idx, layout)
                elif tb_logger is None and self.steps_per_dispatch > 1:
                    losses = self._fit_grouped(data, idx, layout, step_done)
                else:
                    losses = []
                    for i in range(idx.shape[0]):
                        show = i % batch_number_to_show_progress == 0
                        if tb_logger is not None and show:
                            tb_logger.trace_on(epoch)
                        losses.append(self.fit_on_batch(data, idx[i], layout))
                        if step_done is not None:
                            step_done(i)
                        if tb_logger is not None and show:
                            tb_logger.trace_off(epoch)
                        if show:
                            log.debug("Fit: %d/%d batches", i + 1, idx.shape[0])
                    losses = torch.stack(losses)
                # one read of the epoch's losses, averaged in float64
                mean_loss = float(losses.double().mean())
                self.last_mean_loss = mean_loss
                log.info("Fit epoch %d: %d batches, mean loss %.5f", epoch, idx.shape[0],
                         mean_loss)
                if resilience is not None:
                    resilience.epoch_boundary(self, epoch_base + steps_per_epoch, epoch,
                                              mean_loss)

                self.calibrate(X_train)
                eval_results = self._eval_at_epoch(data, y_np, X_valid, y_valid, start_time,
                                                   epoch=epoch, layout=layout)
                if tb_logger is not None:
                    tb_logger.log_params(epoch=epoch, eval_results=eval_results,
                                         metrics=self.metrics, variables=self._host_params())
                if epoch_callback:
                    epoch_callback(model=self, eval_results=eval_results,
                                   df_all=_first_row(X_train))
                progress.update(1)
            if hasattr(progress, "close"):
                progress.close()
        finally:
            if resilience is not None:
                resilience.uninstall()
        return self

    def _host_params(self) -> dict:
        return {k: v.detach().cpu().numpy() for k, v in self.state.params.items()}

    # -- checkpointing -----------------------------------------------------
    def save(self, directory):
        """The whole TrainState and the hparams and feat_dict sidecars
        (``ckpt.save_checkpoint``)."""
        from ..ckpt import save_checkpoint

        save_checkpoint(directory, state=self.state, hparams=self.hparams,
                        feat_dict=self.model.feat_dict)

    def restore(self, directory):
        """The state of a ``save`` directory, on this Trainer's device. A
        checkpoint whose dropout generator was on another device type
        raises ValueError (``ckpt.restore_checkpoint``)."""
        from ..ckpt import restore_checkpoint

        self.state = restore_checkpoint(directory, self.state)
        return self
