"""The plain references against ``recman_tpu_torch`` on the CPU at tiny
sizes: the same weights and rows give the same scores, loss and
gradients; the reference's rounding helpers round as stated."""

from __future__ import annotations

import pytest
import torch

from perfbench import gen, program, spec
from perfbench.reference import common, steps

SEED = 2**31 + 77
CELLS = ("xdeepfm_bench_criteo", "dlrm_mlperf_criteo")
STATED = {"gemm": "f32", "cin": "bf16"}


def _setup(name, n=512):
    cfg = spec.config(name)
    fam = steps.family(cfg["reference"])
    w = gen.glorot_weights(fam.param_shapes(cfg), gen.generator(SEED, gen.WEIGHTS, "cpu"), "cpu")
    # nonzero vectors, so that every leaf enters the comparison
    for k, v in w.items():
        if v.dim() == 1:
            w[k] = 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(len(k)))
    rows = gen.criteo_rows(cfg, n, gen.generator(SEED, gen.ROWS, "cpu"), "cpu")
    return cfg, fam, w, rows


@pytest.mark.parametrize("name", CELLS)
def test_param_shapes_are_the_ports(tiny, name):
    cfg = spec.config(name)
    ported = program.model(cfg).init_params(torch.Generator().manual_seed(0), "cpu")
    shapes = steps.family(cfg["reference"]).param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in ported.items()} == {k: s for k, (s, _) in shapes.items()}


@pytest.mark.parametrize("name", CELLS)
def test_scores_agree(tiny, name):
    cfg, fam, w, rows = _setup(name)
    cats, dense = spec.field_names(cfg)
    chunk = {c: rows["cat"][:, j].numpy() for j, c in enumerate(cats)}
    chunk.update({c: rows["dense"][:, j].numpy() for j, c in enumerate(dense)})
    got = program.ScoreProgram(cfg, {"batch": 200}, w, "cpu").predict(chunk)
    ref = steps.predict(fam, w, rows["cat"], rows["dense"], cfg, STATED, 100).numpy()
    assert got.shape == ref.shape and abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_gradients_agree(tiny, name):
    from recman_tpu_torch.training import gather_batch, unpack_batch
    from recman_tpu_torch.training.train_step import loss_and_grads

    cfg, fam, w, rows = _setup(name)
    idx = torch.arange(300)
    idx[250:] = -1
    loss, grads = steps.loss_and_grads(fam, w, rows, idx, cfg, STATED, 64)
    data, layout = program.packed(cfg, rows)
    batch, weights = gather_batch(data, idx)
    ploss, pgrads = loss_and_grads(program.model(cfg), w, unpack_batch(batch, layout), weights)
    assert abs(float(loss) - float(ploss)) < 1e-5 * abs(float(loss))
    for k, g in grads.items():
        assert torch.allclose(g, pgrads[k], rtol=1e-3, atol=1e-5 * float(g.abs().max()) + 1e-12), k


def test_term_magnitudes_are_the_rows_terms(tiny):
    """DLRM's ops each see a row as one example, so the norm of the sum of
    a leaf's terms' magnitudes is that of |gradient| summed over rows."""
    cfg, fam, w, rows = _setup("dlrm_mlperf_criteo", 64)
    idx = torch.arange(6)
    terms = {}
    steps.loss_and_grads(fam, w, rows, idx, cfg, STATED, 4, terms)
    by_row = [steps.loss_and_grads(fam, w, rows, idx[i:i + 1], cfg, STATED, 4)[1]
              for i in range(6)]
    for k, t in terms.items():
        want = float(torch.linalg.vector_norm(sum(g[k].abs() for g in by_row) / 6,
                                              dtype=torch.float64))
        assert abs(t - want) <= 1e-5 * want, k


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -1 - 2**-11 - 2**-20, 0.0,
                      float("inf")])
    want = torch.tensor([1.0, 1 + 2**-10, 1.0, 1 + 2**-9, -1 - 2**-10, 0.0, float("inf")])
    assert torch.equal(common.round_tf32(x), want)


def test_rounded_matmul_gradients_are_rounded_products():
    a = torch.randn(8, 5, requires_grad=True)
    b = torch.randn(5, 3, requires_grad=True)
    common.matmul(a, b, {"gemm": "tf32"}).sum().backward()
    ones = torch.ones(8, 3)
    assert torch.equal(a.grad, ones @ common.round_tf32(b.detach()).t())
    assert torch.equal(b.grad, common.round_tf32(a.detach()).t() @ ones)


def test_cin_layer_gradient_is_the_autograd_of_its_forward_in_f32():
    """With f32 rounding standing for bf16's the hand-written backward is
    autograd's."""
    x0 = torch.randn(6, 4, dtype=torch.float64)
    xk = torch.randn(6, 3, dtype=torch.float64)
    w = torch.randn(12, 5, dtype=torch.float64)
    args = [t.clone().requires_grad_(True) for t in (x0, xk, w)]
    common._CinLayer.apply(*args, "f32").square().sum().backward()
    plain = [t.clone().requires_grad_(True) for t in (x0, xk, w)]
    z = (plain[0][:, :, None] * plain[1][:, None, :]).reshape(6, 12)
    (z @ plain[2]).square().sum().backward()
    for a, p in zip(args, plain):
        assert torch.allclose(a.grad, p.grad)
