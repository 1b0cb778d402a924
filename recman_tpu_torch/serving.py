"""Serving: batched scoring with a model and its params, and serving
artifacts that need no model code.

Counterpart of ``recman_tpu/serving.py``. ``Predictor.predict`` (:41-117)
encodes a dataframe (or takes encoded arrays), pads the rows into
``n // batch_size + 1`` batches of row indices (-1 marks padding,
reference ``training/trainer.py:44-57``), gathers each batch on the
device with the padding clamped to row 0 (``training.gather_batch``),
runs the eval forward and returns the first ``n`` predictions. The
inference-time linear overrides (``feat.set_weights``) apply unless
``apply_overrides=False``.

``from_checkpoint`` rebuilds the model from a ``Trainer.save``
checkpoint's sidecars and reads its params alone, so a checkpoint written
on the card serves on the CPU and the other way round.

``Predictor.export`` (:119-270) freezes the eval forward at a fixed batch
size into a ``torch.export`` program. The artifact directory holds the
program (``serving_fn.pt2``), the params (``serving_params.npz``, int8
tables under ``name::q8`` and ``name::q8scale``), the schema
(``feat_dict.json``; a pickle only where JSON cannot hold it) and
``serving_meta.json``. The params are inputs of the program, not
constants; the linear overrides active at export time are baked in.
``ExportedPredictor`` (:273-406) serves an artifact with the port's ops
and features alone, without model classes. The artifact holds one program
for each platform it lists: the card's keeps K1 and K4 as the registered
ops ``recman_tpu_torch::cin_chain_fwd`` and
``recman_tpu_torch::cin_interact_fwd``, the CPU's traces the plain path,
and ``ExportedPredictor.load`` takes the one for its device.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle

import numpy as np
import torch

from .ckpt import load_feat_dict, load_hparams, restore_params
from .device import resolve_device
from .obs.trace import span
from .ops.embedding import QuantTable, fused_grad, quantize_table_int8
from .training import batch_indices, gather_batch

EXPORT_BLOB = "serving_fn.pt2"  # the first listed platform's program (``program_file``)
EXPORT_META = "serving_meta.json"
EXPORT_PARAMS = "serving_params.npz"
EXPORT_SCHEMA = "feat_dict.pkl"  # custom-type fallback (trusted sources only)
EXPORT_SCHEMA_JSON = "feat_dict.json"  # preferred: pure data, no code runs on load
Q8, Q8_SCALE = "::q8", "::q8scale"
PLATFORMS = ("cpu", "cuda")
# the embedding tables' names end so: a (V, k) table, a QR quotient or remainder table
TABLE_SUFFIXES = ("_feat_embed", "_feat_embed_q", "_feat_embed_r")

__all__ = ["ExportedPredictor", "Predictor", "batch_indices", "op_nodes"]

# Rows scored (ROWS), padding rows scored beside them (PADDED_ROWS: the
# last batch's tail, ``n // batch_size + 1`` batches a request) and bytes
# copied to the device (H2D_BYTES: the columns, the row indices and the
# override vector), counted by ``Predictor.predict`` from sizes alone; no
# counter reads a tensor's values.
ROWS = 0
PADDED_ROWS = 0
H2D_BYTES = 0


def program_file(platforms, platform) -> str:
    """The file of ``platform``'s program in an artifact for ``platforms``."""
    return EXPORT_BLOB if platform == platforms[0] else f"serving_fn_{platform}.pt2"


def op_nodes(directory, platform=None) -> set:
    """The port's kernel ops among the graph nodes of an artifact's program
    for ``platform`` (default: the first platform it lists)."""
    with open(os.path.join(directory, EXPORT_META)) as f:
        platforms = json.load(f)["platforms"]
    path = os.path.join(directory, program_file(platforms, platform or platforms[0]))
    program = torch.export.load(path)
    return {str(n.target) for n in program.graph.nodes if "recman_tpu_torch" in str(n.target)}


class Predictor:
    """Inference-only wrapper around a model and its params, on one device
    (default CUDA; raises without a GPU unless ``device="cpu"``)."""

    def __init__(self, model, params, batch_size=4096, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.batch_size = batch_size

    @classmethod
    def from_checkpoint(cls, directory, model_name_or_cls, hparams=None, task="classification",
                        batch_size=4096, device=None):
        """Rebuild the model and its params from a ``Trainer.save`` or
        ``BestModelFinder`` checkpoint directory. ``hparams`` update the
        saved ones (the hparams sidecar keeps a tuple as its string)."""
        feat_dict = load_feat_dict(directory)
        try:
            saved_hp = load_hparams(directory)
        except FileNotFoundError:
            saved_hp = {}
        hp = dict(saved_hp)
        hp.update(hparams or {})
        from .models import model_class  # serving an artifact needs no model code

        model_cls = (model_class(model_name_or_cls) if isinstance(model_name_or_cls, str)
                     else model_name_or_cls)
        model = model_cls(feat_dict, hp, task=task)
        device = resolve_device(device)
        template = model.init_params(torch.Generator().manual_seed(0), device)
        return cls(model, restore_params(directory, template), batch_size=batch_size,
                   device=device)

    def predict(self, X, apply_overrides=True) -> np.ndarray:
        """Batched scoring of a dataframe or an encoded-array dict."""
        global ROWS, PADDED_ROWS, H2D_BYTES
        with span("predict"):
            data = dict(X) if isinstance(X, dict) else self.model.feat_dict.transform(X)
            data.pop("y", None)
            n = len(next(iter(data.values())))
            with span("predict.h2d"):
                data = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                        for k, v in data.items()}
                override = self._override(apply_overrides)
                rows = batch_indices(n, self.batch_size)
                idx = torch.as_tensor(rows).to(self.device)
            ROWS += n
            PADDED_ROWS += rows.size - n
            H2D_BYTES += sum(t.nbytes for t in data.values()) + idx.nbytes + (
                0 if override is None else override.nbytes)
            with torch.inference_mode():
                outs = []
                for i in range(idx.shape[0]):
                    with span("predict.forward"):
                        outs.append(self.model.apply(
                            self.params, gather_batch(data, idx[i])[0], training=False,
                            linear_override=override,
                        ))
                with span("predict.d2h"):
                    return torch.cat(outs).cpu().numpy()[:n]

    def _override(self, apply_overrides):
        """The linear tower's override vector on the device, or None."""
        linear = getattr(self.model, "linear", None)
        if not apply_overrides or linear is None:
            return None
        with span("predict.override"):
            return torch.as_tensor(linear.override_vector()).to(self.device)

    def export(self, directory, sample_X, batch_size=None, platforms=None,
               apply_overrides=True, quantize_embeddings=False):
        """Freeze the eval forward into a serving artifact in ``directory``.

        ``sample_X`` (a dataframe or an encoded dict) gives the batch's
        arrays, their trailing shapes and dtypes; the program takes a fixed
        batch of ``batch_size`` rows (default the predictor's), and
        ``ExportedPredictor.predict`` edge-pads the last one. ``platforms``
        (default the predictor's device type) are the device types the
        artifact may serve on, of "cpu" and "cuda", and each gets a program
        of its own: the card's keeps K1 and K4 as op nodes, the CPU's
        traces the plain path under ``fused_grad(False)`` (the reference's
        portability gate, :213-227). The linear overrides active now are
        baked in when ``apply_overrides``.

        ``quantize_embeddings`` stores the (V, k) tables (QR quotient and
        remainder tables too) as per-row symmetric int8 and f32 scales:
        ``True`` dequantizes them once at load, "runtime" keeps them int8
        on the device and dequantizes each looked-up row after the gather
        (``ops.embedding.QuantTable``), 4k/(k+4) times fewer table bytes.
        Dice's frozen moments (``Trainer.calibrate``) are params like any
        other, so the program's predictions do not depend on the batch's
        other rows.
        """
        bs = int(batch_size or self.batch_size)
        if isinstance(sample_X, dict):
            sample = {k: np.asarray(v) for k, v in sample_X.items()}
        else:
            sample = self.model.feat_dict.transform(sample_X)
        sample.pop("y", None)
        platforms = tuple(dict.fromkeys(p.lower() for p in (platforms or (self.device.type,))))
        if not set(platforms) <= set(PLATFORMS):
            raise ValueError(f"platforms must be of {PLATFORMS}, got {platforms}")
        if quantize_embeddings not in (False, True, "runtime"):
            raise ValueError(f"quantize_embeddings must be False, True or 'runtime', "
                             f"got {quantize_embeddings!r}")
        runtime_quant = quantize_embeddings == "runtime"

        trace_params, stored, quantized = {}, {}, []
        for k, v in self.params.items():
            a = v.detach().cpu().numpy()
            if quantize_embeddings and k.endswith(TABLE_SUFFIXES) and a.ndim == 2 \
                    and a.dtype == np.float32:
                q, scale = quantize_table_int8(a)
                stored[k + Q8], stored[k + Q8_SCALE] = q, scale
                quantized.append(k)
                if runtime_quant:
                    trace_params[k + Q8] = torch.from_numpy(q).to(self.device)
                    trace_params[k + Q8_SCALE] = torch.from_numpy(scale).to(self.device)
                    continue
            else:
                stored[k] = a
            trace_params[k] = v

        batch_keys = sorted(sample)
        n = len(sample[batch_keys[0]])
        if n == 0:
            raise ValueError("sample_X has no rows")
        rows = np.minimum(np.arange(bs), n - 1)  # the sample's rows, the last repeated
        batch = {k: torch.from_numpy(np.ascontiguousarray(sample[k][rows])).to(self.device)
                 for k in batch_keys}
        serve = _Serve(self.model, self._override(apply_overrides),
                       quantized if runtime_quant else ())
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        for platform in platforms:
            gate = fused_grad(False) if platform == "cpu" else contextlib.nullcontext()
            with gate, torch.no_grad():
                program = torch.export.export(serve, (trace_params, batch))
            program.example_inputs = None  # the tables stay out of the blob
            torch.export.save(program, os.path.join(directory, program_file(platforms, platform)))
        np.savez(os.path.join(directory, EXPORT_PARAMS), **stored)
        # the schema as JSON where every type has a JSON form (safe to load
        # from anywhere); a pickle only for custom encoder or scaler
        # objects, to be loaded from a trusted source alone
        try:
            from .features import schema_to_json

            schema_json = schema_to_json(self.model.feat_dict)
        except TypeError:
            with open(os.path.join(directory, EXPORT_SCHEMA), "wb") as f:
                pickle.dump(self.model.feat_dict, f, protocol=pickle.HIGHEST_PROTOCOL)
        else:
            with open(os.path.join(directory, EXPORT_SCHEMA_JSON), "w") as f:
                f.write(schema_json)
        meta = {
            "model": self.model.name,
            "batch_size": bs,
            "batch_keys": batch_keys,
            "param_keys": list(trace_params),
            "platforms": list(platforms),
            "device": self.device.type,
            "quantized": quantized,
            "quant_mode": "runtime" if runtime_quant else ("load" if quantized else "none"),
        }
        with open(os.path.join(directory, EXPORT_META), "w") as f:
            json.dump(meta, f, indent=2)
        return directory


class _Serve(torch.nn.Module):
    """The exported function: (params, batch) -> predictions. Under
    runtime quantization each int8 table comes in as its two halves
    (``name::q8``, ``name::q8scale``) and is rebuilt as a ``QuantTable``
    inside the program."""

    def __init__(self, model, override, quant_tables):
        super().__init__()
        self.model = model
        self.override = override
        self.quant_tables = tuple(quant_tables)

    def forward(self, params, batch):
        params = dict(params)
        for name in self.quant_tables:
            params[name] = QuantTable(params.pop(name + Q8), params.pop(name + Q8_SCALE))
        return self.model.apply(params, batch, training=False, linear_override=self.override)


class ExportedPredictor:
    """Serves an artifact written by ``Predictor.export``: no model code and
    no tracing, the program loaded and called."""

    def __init__(self, program, params, feat_dict, meta, device):
        self._call = program
        # the program's params in the order it was traced with (a dict
        # flattens by key order), a runtime-int8 table as its int8
        # ``name::q8`` and f32 ``name::q8scale``
        self.params = {k: params[k] for k in meta["param_keys"]}
        self.feat_dict = feat_dict
        self.meta = meta
        self.device = device
        self.batch_size = int(meta["batch_size"])
        self.batch_keys = list(meta["batch_keys"])

    @classmethod
    def load(cls, directory, device=None):
        """Read the artifact's program for ``device`` (default CUDA; raises
        without a GPU unless ``device="cpu"``), which must be one of its
        platforms. Every param is placed on the device once: int8 tables
        stay int8 under "runtime" (the program makes each a ``QuantTable``)
        and are dequantized here under ``quantize_embeddings=True``."""
        from . import ops  # noqa: F401  registers K1's and K4's ops before the program loads

        device = resolve_device(device)
        directory = os.path.abspath(directory)
        with open(os.path.join(directory, EXPORT_META)) as f:
            meta = json.load(f)
        if device.type not in meta["platforms"]:
            raise ValueError(f"the artifact serves on {meta['platforms']}, not {device.type}")
        path = os.path.join(directory, program_file(meta["platforms"], device.type))
        program = torch.export.load(path)
        if meta["device"] != device.type:  # traced on the other device type
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, device)
        runtime_quant = meta["quant_mode"] == "runtime"
        params = {}
        with np.load(os.path.join(directory, EXPORT_PARAMS)) as z:
            for k in z.files:
                if runtime_quant or not k.endswith((Q8, Q8_SCALE)):
                    params[k] = torch.from_numpy(z[k]).to(device)
                elif k.endswith(Q8):  # dequantized once, here
                    name = k[: -len(Q8)]
                    params[name] = torch.from_numpy(
                        z[k].astype(np.float32) * z[name + Q8_SCALE][:, None]).to(device)
        schema_json = os.path.join(directory, EXPORT_SCHEMA_JSON)
        if os.path.exists(schema_json):
            from .features import schema_from_json

            with open(schema_json) as f:
                feat_dict = schema_from_json(f.read())
        else:
            # unpickling runs arbitrary code: trusted artifacts only
            with open(os.path.join(directory, EXPORT_SCHEMA), "rb") as f:
                feat_dict = pickle.load(f)
        return cls(program.module(), params, feat_dict, meta, device)

    def _to_device(self, cols, start, side):
        """The batch at row ``start``, edge-padded to the batch size, on the
        device: on the card copied from pinned memory on the ``side``
        stream, with an event recorded after the copies."""
        bs = self.batch_size
        batch = [c[start:start + bs] for c in cols]
        m = len(batch[0])
        if m < bs:
            batch = [torch.cat([c, c[-1:].expand(bs - m, *c.shape[1:])]) for c in batch]
        if side is None:
            return m, batch, None
        with torch.cuda.stream(side):
            batch = [c.pin_memory().to(self.device, non_blocking=True) for c in batch]
            ready = torch.cuda.Event()
            ready.record(side)
        return m, batch, ready

    def predict(self, X) -> np.ndarray:
        """Batched scoring of a dataframe or an encoded-array dict; rows are
        edge-padded up to the exported batch size and trimmed after.

        Double-buffered (reference :335-406): batch i+1 is sliced, padded
        and its copy to the device issued before batch i's call, and each
        result is read one batch behind. On the card the copies run from
        pinned memory on a side stream (a copy on the default stream would
        wait behind the queued compute), the program's stream waits for
        them, and each result comes back into pinned memory behind its
        call, so the host waits for batch i-1 while batch i runs. No
        producer thread: the copies are asynchronous already, and a second
        Python thread contends with the launches for the interpreter
        lock."""
        if isinstance(X, dict):
            data = {k: np.asarray(v) for k, v in X.items()}
        else:
            data = self.feat_dict.transform(X)
        data.pop("y", None)
        missing = [k for k in self.batch_keys if k not in data]
        if missing:
            raise ValueError(f"input is missing encoded columns: {missing}")
        n = len(data[self.batch_keys[0]])
        if n == 0:
            return np.empty((0,), dtype=np.float32)

        cols = [torch.from_numpy(np.ascontiguousarray(data[k])) for k in self.batch_keys]
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        stream = torch.cuda.current_stream(self.device) if cuda else None
        outs, pending = [], []
        nxt = self._to_device(cols, 0, side)
        with torch.inference_mode():
            for start in range(0, n, self.batch_size):
                m, batch, ready = nxt
                if start + self.batch_size < n:
                    nxt = self._to_device(cols, start + self.batch_size, side)
                if cuda:
                    stream.wait_event(ready)
                    for t in batch:
                        t.record_stream(stream)  # allocated on the side stream
                out = self._call(self.params, dict(zip(self.batch_keys, batch)))
                done = None
                if cuda:
                    out = out.to("cpu", non_blocking=True)  # into pinned memory, behind the call
                    done = torch.cuda.Event()
                    done.record(stream)
                pending.append((m, out, done))
                if len(pending) > 1:  # read results one batch behind
                    outs.append(self._result(*pending.pop(0)))
            outs += [self._result(*p) for p in pending]
        return np.concatenate(outs)[:n]

    @staticmethod
    def _result(m, out, done):
        if done is not None:
            done.synchronize()
        return out.numpy()[:m]
