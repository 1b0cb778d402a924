"""Training steps and scoring with a family's plain reference, in blocks of
rows so that a batch of any size fits beside nothing else.

A family module (``reference/<family>.py``) gives ``param_shapes(cfg)``,
``forward(params, cat, dense, cfg, prec)`` and ``l2(params, cfg)``.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

from .common import Optimizer, bce, schedule, set_float32_exact, term_magnitude, term_sums


def family(name: str):
    return importlib.import_module(f"{__package__}.{name}")


def loss_and_grads(fam, params, rows, idx, cfg, prec, block, terms=None):
    """(loss, {name: gradient}) of the batch ``idx`` (rows of ``rows``; -1
    is padding, weight 0): the weighted mean cross-entropy over the rows
    plus the regularizers, the gradient summed over blocks of rows. With a
    dict ``terms``, each leaf's norm of the sum over rows of its loss
    terms' magnitudes (``common.term_sums``) goes there."""
    set_float32_exact()
    names = list(params)
    leaves = [params[k].detach().requires_grad_(True) for k in names]
    live = dict(zip(names, leaves))
    w = (idx >= 0).to(torch.float32)
    safe = idx.clamp_min(0).long()
    total_w = w.sum().clamp_min(1.0)
    loss = torch.zeros((), dtype=torch.float32, device=w.device)
    grads = dict.fromkeys(names)

    def add(term):
        for k, g in zip(names, torch.autograd.grad(term, leaves, allow_unused=True)):
            if g is not None:
                grads[k] = g if grads[k] is None else grads[k] + g

    parts = {}
    with term_sums(live, parts) if terms is not None else contextlib.nullcontext():
        for s in range(0, idx.shape[0], block):
            r = safe[s:s + block]
            p = fam.forward(live, rows["cat"][r], rows["dense"][r], cfg, prec)
            part = (bce(rows["y"][r], p) * w[s:s + block]).sum() / total_w
            add(part)
            loss = loss + part.detach()
    reg = fam.l2(live, cfg)
    if isinstance(reg, torch.Tensor) and reg.requires_grad:
        add(reg)
        loss = loss + reg.detach()
    if terms is not None:
        terms.update({k: term_magnitude(live[k], parts.pop(k, [])) for k in names})
    return loss, {k: torch.zeros_like(v) if grads[k] is None else grads[k]
                  for k, v in live.items()}


@torch.no_grad()
def predict(fam, params, cat, dense, cfg, prec, block) -> torch.Tensor:
    """Probabilities of rows (cat, dense), ``block`` rows at a time."""
    set_float32_exact()
    return torch.cat([fam.forward(params, cat[s:s + block], dense[s:s + block], cfg, prec)
                      for s in range(0, cat.shape[0], block)])


class Stepper:
    """The reference's training loop over a pool of rows: ``step(idx)``
    is one optimizer step on the rows ``idx``; ``first_grads`` is the
    gradient of the first step, ``terms`` its leaves' norms of their
    terms' magnitudes."""

    def __init__(self, cfg, params, rows, batch, prec):
        self.cfg, self.rows, self.prec = cfg, rows, prec
        self.fam = family(cfg["reference"])
        opt = cfg["optimizer"]
        self.opt = Optimizer(opt["name"], schedule(opt["schedule"], batch))
        self.params = {k: v.detach() for k, v in params.items()}
        self.first, self.terms = None, None

    def step(self, idx):
        terms = {} if self.first is None else None
        loss, grads = loss_and_grads(self.fam, self.params, self.rows, idx, self.cfg,
                                     self.prec, self.cfg["reference_block_rows"], terms)
        if self.first is None:
            self.first, self.terms = grads, terms
        self.params = self.opt.step(self.params, grads)
        return loss

    def first_grads(self, p0):
        del p0
        return self.first
