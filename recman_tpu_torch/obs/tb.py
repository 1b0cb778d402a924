"""TensorBoard logging + profiler hooks.

Counterpart of ``recman_tpu/obs/tb.py`` (reference surface:
TensorBoardLogger, recman/tf/core/TensorBoardLogger.py:12-87 — per-(run,
session) writer, hparams registration, trace_on/off, per-epoch variable
histograms + TRAIN_/VALID_ scalar metrics). Backed by tensorboardX when
it imports, else by the JSONL fallback (``<path>.metrics.jsonl``).
Tracing maps to ``torch.profiler``, whose TensorBoard trace handler
writes under the session's path; it runs only where the reference starts
its profiler trace (``profile=True``).
"""

from __future__ import annotations

import logging
import os
from datetime import datetime

import numpy as np

log = logging.getLogger(__name__)


class TensorBoardLogger:
    def __init__(self, hp_params=None, sess_num=0, log_dir="./logs", run_name=None,
                 profile=False):
        if run_name is None:
            run_name = datetime.now().strftime("%Y%m%d-%H%M%S")
        self.hp_params = hp_params
        self.log_dir = log_dir
        self.run_name = run_name
        self.sess_num = sess_num
        self.profile = profile
        self._tracing = False
        self._profiler = None
        self._traced_epochs = set()
        self.path = f"{self.log_dir}/{self.run_name}/hp_{self.sess_num}"
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(self.path)
        except Exception:  # pragma: no cover - fallback when tbX is absent
            self.writer = None
            log.warning("tensorboardX unavailable; falling back to JSONL metrics")
            # the reference opens the file without making its directory,
            # and so fails here when the run directory is new
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._jsonl = open(f"{self.path}.metrics.jsonl", "a") if self.writer is None else None

    # -- hparams (reference TensorBoardLogger.py:28-56) --------------------
    @staticmethod
    def metric_matrix(metrics) -> list:
        """The hparams-plugin metric tags: TRAIN_/VALID_/TEST_ x metrics
        (reference TensorBoardLogger.py:34-44 itertools.product). Tags use
        the same str(metric) formatting as the per-epoch scalars, so the
        plugin joins registration with the logged values."""
        import itertools

        return [
            f"{prefix}{m}"
            for prefix, m in itertools.product(("TRAIN_", "VALID_", "TEST_"),
                                               metrics)
        ]

    def _stringify(self, name, value):
        """advanced_dtype semantics (reference BaseHyperParameters.py:41-48
        + TensorBoardLogger.py:46-55): non-plugin-primitive values are
        exported as strings."""
        advanced = False
        if self.hp_params is not None and name in self.hp_params:
            advanced = self.hp_params[name].advanced_dtype
        if advanced or not isinstance(value, (bool, int, float, str)):
            return getattr(value, "__name__", None) or str(value)
        return value

    def _experiment_summary(self, hp_val, metrics):
        """hparams-plugin Experiment proto: the FULL grid domains (from the
        registered hp_params, falling back to this session's values) + the
        metric matrix — what the reference's hp.hparams_config registers
        (TensorBoardLogger.py:33-45). tensorboardX's add_hparams can't
        express domains or metric-only registration, so the proto is built
        directly."""
        from google.protobuf import struct_pb2
        from tensorboardX.proto.api_pb2 import (
            DataType, Experiment, HParamInfo, MetricInfo, MetricName,
        )
        from tensorboardX.proto.plugin_hparams_pb2 import HParamsPluginData
        from tensorboardX.proto.summary_pb2 import Summary, SummaryMetadata

        hp_infos = []
        for name in (self.hp_params or hp_val):
            if self.hp_params is not None and name in self.hp_params:
                domain = self.hp_params[name].hp_domain
            else:
                domain = [hp_val[name]] if name in hp_val else []
            vals = [self._stringify(name, v) for v in domain]
            if vals and all(isinstance(v, bool) for v in vals):
                dtype = DataType.Value("DATA_TYPE_BOOL")
            elif vals and all(isinstance(v, (int, float)) for v in vals):
                dtype = DataType.Value("DATA_TYPE_FLOAT64")
                vals = [float(v) for v in vals]
            else:
                dtype = DataType.Value("DATA_TYPE_STRING")
                vals = [str(v) for v in vals]
            lv = struct_pb2.ListValue()
            lv.extend(vals)
            hp_infos.append(HParamInfo(
                name=name, display_name=name, type=dtype, domain_discrete=lv,
            ))
        mt_infos = [
            MetricInfo(name=MetricName(tag=t), display_name=t)
            for t in self.metric_matrix(metrics)
        ]
        content = HParamsPluginData(
            experiment=Experiment(hparam_infos=hp_infos,
                                  metric_infos=mt_infos),
            version=0,
        )
        smd = SummaryMetadata(plugin_data=SummaryMetadata.PluginData(
            plugin_name="hparams", content=content.SerializeToString(),
        ))
        return Summary(value=[Summary.Value(tag="_hparams_/experiment",
                                            metadata=smd)])

    def configure_hparams(self, hp_val, metrics):
        log.info("Configure hyper-params on session %s: %s", self.sess_num, hp_val)
        clean = {k: self._stringify(k, v) for k, v in dict(hp_val).items()}
        if self.writer is None:
            if self._jsonl is not None:
                import json

                self._jsonl.write(json.dumps({
                    "hparams": {k: str(v) for k, v in clean.items()},
                    "metrics": self.metric_matrix(metrics),
                }) + "\n")
                self._jsonl.flush()
            return
        try:
            from tensorboardX.summary import hparams as tbx_hparams

            # session start/end protos from tbX; the experiment proto is
            # replaced by ours (grid domains + full metric matrix)
            _, ssi, sei = tbx_hparams(
                clean, {t: None for t in self.metric_matrix(metrics)}
            )
            fw = self.writer._get_file_writer()
            fw.add_summary(self._experiment_summary(hp_val, metrics))
            fw.add_summary(ssi)
            fw.add_summary(sei)
            self.writer.flush()
        except Exception as e:  # hparams protos can be picky about dtypes
            log.debug("hparams registration failed: %s", e)

    # -- profiler (reference TensorBoardLogger.py:58-69) -------------------
    def trace_on(self, epoch=-1, **_):
        """Start a torch.profiler trace once per epoch when profiling is on."""
        if not self.profile or self._tracing or epoch in self._traced_epochs:
            return
        import torch

        try:
            self._profiler = torch.profiler.profile(
                on_trace_ready=torch.profiler.tensorboard_trace_handler(self.path)
            )
            self._profiler.start()
            self._tracing = True
            self._traced_epochs.add(epoch)
        except Exception as e:  # already profiling elsewhere etc.
            log.debug("profiler start failed: %s", e)

    def trace_off(self, epoch=-1):
        if not self._tracing:
            return
        try:
            self._profiler.stop()
        finally:
            self._tracing = False
            self._profiler = None

    # -- per-epoch logging (reference TensorBoardLogger.py:71-87) ----------
    def log_params(self, epoch, eval_results, metrics, variables):
        if self.writer is not None:
            for name, value in variables.items():
                try:
                    self.writer.add_histogram(name, np.asarray(value), epoch)
                except Exception:
                    pass
        self._log_eval(epoch, eval_results, metrics)

    def _log_eval(self, epoch, eval_results, metrics):
        train_res, valid_res = eval_results
        rows = {}
        for m, r in zip(metrics, train_res):
            rows[f"TRAIN_{m}"] = float(r)
        if valid_res is not None:
            for m, r in zip(metrics, valid_res):
                rows[f"VALID_{m}"] = float(r)
        if self.writer is not None:
            for tag, val in rows.items():
                self.writer.add_scalar(tag, val, epoch)
            self.writer.flush()
        elif self._jsonl is not None:
            import json

            self._jsonl.write(json.dumps({"epoch": epoch, **rows}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self._jsonl is not None:
            self._jsonl.close()
