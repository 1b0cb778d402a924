"""Checkpoint save/restore: one torch-native state file + the reference's
schema/hparam sidecars.

Counterpart of ``recman_tpu/ckpt/checkpoint.py``. The reference writes
its TrainState with Orbax; here the whole state (params, every optimizer
state tensor, step, the dropout generator) goes into ``state/state.pt``,
so a restore continues Adam's moments and the dropout stream exactly. The
file holds only tensors, strings, ints, None and dicts, so it loads with
``torch.load(weights_only=True)``:

- ``params``: {flat param name: tensor}, the reference's names;
- ``opt_state``: {path: tensor, ``"MaskedNode"`` or None}, a path being
  the tuple of NamedTuple field names and dict keys from the optimizer
  state's root (``("inner_states", "table", "mu", "C1_feat_embed")``);
- ``step``: int;
- ``generator``: None or {"device_type": str, "state": uint8 tensor}.

The sidecars (``hparams.json``, ``feat_dict.json`` or the pickle
fallback) are written by the reference's own code, so they are
byte-equal to what the JAX package writes for the same model and hparams.
"""

from __future__ import annotations

import json
import logging
import os
import pickle

import torch

from ..training.train_step import MASKED, MaskedNode, TrainState

log = logging.getLogger(__name__)

STATE_DIR = "state"
STATE_FILE = "state.pt"
HPARAMS_FILE = "hparams.json"
FEAT_DICT_FILE = "feat_dict.pkl"  # legacy/custom-type fallback
FEAT_DICT_JSON_FILE = "feat_dict.json"  # preferred: pure data, no code exec
MASKED_LEAF = "MaskedNode"


def _flatten(tree, path=()):
    """[(path, leaf)] over an optimizer state: NamedTuples by field name,
    dicts by key; leaves are tensors, MaskedNode (as ``MASKED_LEAF``) and
    None."""
    if tree is None or isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, MaskedNode):
        return [(path, MASKED_LEAF)]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _flatten(getattr(tree, f), path + (f,))]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, path + (k,))]
    raise TypeError(f"optimizer state leaf {'/'.join(map(str, path))} is a "
                    f"{type(tree).__name__}; a checkpoint takes tensors, MaskedNode and None")


def _unflatten(template, leaves: dict, path=()):
    """``template``'s structure with each leaf taken from ``leaves``."""
    if template is None or isinstance(template, (torch.Tensor, MaskedNode)):
        return leaves[path]
    if hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves, path + (f,))
                                for f in template._fields))
    return {k: _unflatten(v, leaves, path + (k,)) for k, v in template.items()}


def _restore_leaves(saved: dict, template: dict, what: str) -> dict:
    """{key: template leaf} -> {key: saved leaf on the template's device},
    after checking names, kinds, shapes and dtypes; raises ValueError
    naming the first that differs."""
    for key in template:
        if key not in saved:
            raise ValueError(f"checkpoint has no {what} {key!r}")
    for key in saved:
        if key not in template:
            raise ValueError(f"checkpoint has {what} {key!r}, which the template lacks")
    out = {}
    for key, t in template.items():
        s = saved[key]
        if not isinstance(t, torch.Tensor):  # MASKED_LEAF or None
            if isinstance(s, torch.Tensor) or s != t:
                raise ValueError(f"{what} {key!r} is {s!r} in the checkpoint, "
                                 f"{t!r} in the template")
            out[key] = MASKED if t == MASKED_LEAF else None
            continue
        if not isinstance(s, torch.Tensor):
            raise ValueError(f"{what} {key!r} is {s!r} in the checkpoint, a tensor in the template")
        if s.shape != t.shape:
            raise ValueError(f"{what} {key!r} has shape {tuple(s.shape)} in the checkpoint, "
                             f"{tuple(t.shape)} in the template")
        if s.dtype != t.dtype:
            raise ValueError(f"{what} {key!r} has dtype {s.dtype} in the checkpoint, "
                             f"{t.dtype} in the template")
        out[key] = s.to(t.device)
    return out


def save_checkpoint(directory, state: TrainState, hparams=None, feat_dict=None):
    """Write the TrainState + sidecars under ``directory``. The state file
    is written to a temporary name and renamed into place."""
    directory = os.path.abspath(directory)
    os.makedirs(os.path.join(directory, STATE_DIR), exist_ok=True)

    gen = state.generator
    blob = {
        "params": {k: v.detach() for k, v in state.params.items()},
        "opt_state": dict(_flatten(state.opt_state)),
        "step": int(state.step),
        "generator": None if gen is None else {"device_type": gen.device.type,
                                               "state": gen.get_state()},
    }
    path = os.path.join(directory, STATE_DIR, STATE_FILE)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)

    if hparams is not None:
        clean = {
            k: (v if isinstance(v, (bool, int, float, str)) else str(v))
            for k, v in dict(hparams).items()
        }
        with open(os.path.join(directory, HPARAMS_FILE), "w") as f:
            json.dump(clean, f, indent=2)
    if feat_dict is not None:
        # JSON when every feature type round-trips (loads without code
        # execution); pickle fallback for custom encoder/scaler objects
        try:
            from ..features import schema_to_json

            schema_json = schema_to_json(feat_dict)
        except TypeError:
            with open(os.path.join(directory, FEAT_DICT_FILE), "wb") as f:
                pickle.dump(feat_dict, f, protocol=pickle.HIGHEST_PROTOCOL)
        else:
            with open(os.path.join(directory, FEAT_DICT_JSON_FILE), "w") as f:
                f.write(schema_json)
    log.info("Checkpoint saved to %s", directory)


def _load(directory) -> dict:
    path = os.path.join(os.path.abspath(directory), STATE_DIR, STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(directory, state_template: TrainState) -> TrainState:
    """A TrainState of ``state_template``'s structure, every tensor on the
    template's tensor's device, so a checkpoint written on the card
    restores on the CPU and the other way round.

    The dropout generator is restored onto a new generator of the
    template generator's device; a template generator of another device
    type raises ValueError (pass ``generator=None`` in the template to
    restore params, moments and step alone: the result's generator is
    then None)."""
    blob = _load(directory)
    generator = None
    tgen = state_template.generator
    if tgen is not None:
        saved = blob["generator"]
        if saved is None:
            raise ValueError(f"checkpoint {directory} holds no dropout generator")
        if saved["device_type"] != tgen.device.type:
            raise ValueError(
                f"checkpoint {directory} holds a {saved['device_type']} dropout generator, "
                f"which cannot be restored onto a {tgen.device.type} one; restore with "
                "generator=None in the template to carry params, moments and step across")
        generator = torch.Generator(device=tgen.device)
        generator.set_state(saved["state"])
    params = _restore_leaves(blob["params"], state_template.params, "param")
    leaves = _restore_leaves(blob["opt_state"], dict(_flatten(state_template.opt_state)),
                             "optimizer state")
    log.info("Checkpoint restored from %s", directory)
    return TrainState(params, _unflatten(state_template.opt_state, leaves), int(blob["step"]),
                      generator)


def restore_params(directory, params_template: dict) -> dict:
    """The checkpoint's params alone, checked against and placed like
    ``params_template`` (serving: no moments, no generator)."""
    return _restore_leaves(_load(directory)["params"], params_template, "param")


def load_feat_dict(directory):
    json_path = os.path.join(directory, FEAT_DICT_JSON_FILE)
    if os.path.exists(json_path):
        from ..features import schema_from_json

        with open(json_path) as f:
            return schema_from_json(f.read())
    # legacy/custom-type checkpoints: unpickling executes arbitrary code —
    # only load checkpoints from a trusted source
    with open(os.path.join(directory, FEAT_DICT_FILE), "rb") as f:
        return pickle.load(f)


def load_hparams(directory):
    with open(os.path.join(directory, HPARAMS_FILE)) as f:
        return json.load(f)
