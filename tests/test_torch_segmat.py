"""K3's plain twin (recman_tpu_torch/ops/segment_matmul.py) and the
stacked lookup's gradient (recman_tpu_torch/ops/embedding.py) against the
JAX package on the CPU.

The reference side is ``_segment_matmul_from_sorted_batched`` run in
Pallas interpret mode, and ``_stacked_gather_split`` under
``fused_grad(True), grad_kernel("segmat")``. Tolerance 1e-6 of the
largest grad: both sides sum the same f32 cotangents per id, in another
order (the twin exactly, through float64 prefix sums); columns no id
falls in are exactly 0 on both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recman_tpu.ops import embedding as jax_emb
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.ops import segment_matmul

TOL = 1e-6


def _case(t, c, n, v, zipf, seed):
    rs = np.random.RandomState(seed)
    if zipf:  # the synthetic Criteo skew (data/criteo.py:104): a few ids take most rows
        ids = np.minimum(rs.zipf(1.2, size=(t, n)) + 1, v - 1)
    else:
        ids = rs.randint(0, v, size=(t, n))
    sids = np.sort(ids.astype(np.int32), axis=1)
    sg = rs.randn(t, c, n).astype(np.float32)
    return sids, sg


@pytest.mark.parametrize(
    "t,c,n,v,zipf",
    [(3, 5, 70, 50, False), (3, 5, 70, 50, True), (4, 17, 512, 1001, True), (1, 3, 9, 4000, False)],
)
def test_twin_matches_jax_interpret(t, c, n, v, zipf):
    sids, sg = _case(t, c, n, v, zipf, seed=t * 7 + n)
    ref = np.asarray(jax_emb._segment_matmul_from_sorted_batched(
        jnp.asarray(sids), jnp.asarray(sg), v, interpret=True))
    got = segment_matmul.segment_matmul_from_sorted_batched(
        torch.from_numpy(sids), torch.from_numpy(sg), v).numpy()
    assert got.shape == ref.shape == (t, c, v) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    np.testing.assert_array_equal(got == 0, ref == 0)
    present = np.zeros((t, v), bool)
    for i in range(t):
        present[i, sids[i]] = True
    assert (got[np.broadcast_to(~present[:, None, :], got.shape)] == 0).all()


def test_twin_ignores_ids_outside_the_vocab():
    sids = torch.tensor([[-3, -1, 0, 2, 2, 5, 9]], dtype=torch.int32)
    sg = torch.arange(1, 8, dtype=torch.float32)[None, None, :].repeat(1, 2, 1)
    got = segment_matmul.segment_matmul_reference(sids, sg, 5)
    assert got[0, 0].tolist() == [3.0, 0.0, 9.0, 0.0, 0.0]
    assert torch.equal(got[0, 0], got[0, 1])


def test_twin_sums_a_long_run_exactly():
    # one id takes every row: the column is the exact sum, rounded once
    rs = np.random.RandomState(1)
    sg = rs.randn(1, 2, 5000).astype(np.float32)
    got = segment_matmul.segment_matmul_reference(
        torch.zeros((1, 5000), dtype=torch.int32), torch.from_numpy(sg), 3)
    np.testing.assert_array_equal(got[0, :, 0].numpy(),
                                  sg[0].astype(np.float64).sum(1).astype(np.float32))
    assert (got[0, :, 1:] == 0).all()


def test_cpu_path_does_not_count_launches():
    before = segment_matmul.LAUNCHES
    sids, sg = _case(2, 3, 40, 30, True, seed=0)
    segment_matmul.segment_matmul_from_sorted_batched(
        torch.from_numpy(sids), torch.from_numpy(sg), 30)
    assert segment_matmul.LAUNCHES == before


@pytest.mark.parametrize(
    "sids,sg,match",
    [
        (torch.zeros((2, 8), dtype=torch.int64), torch.zeros((2, 3, 8)), "int32"),
        (torch.zeros((2, 8), dtype=torch.int32), torch.zeros((2, 3, 8), dtype=torch.float64), "float32"),
        (torch.zeros((2, 7), dtype=torch.int32), torch.zeros((2, 3, 8)), "do not match"),
        (torch.zeros((8, 2), dtype=torch.int32).t(), torch.zeros((2, 3, 8)), "contiguous"),
    ],
)
def test_k3_wrapper_rejects_bad_arguments(sids, sg, match):
    with pytest.raises(ValueError, match=match):
        segment_matmul._segment_matmul_cuda(sids, sg, 10)


@pytest.mark.parametrize("t,v,k,n,zipf", [(3, 40, 4, 64, True), (5, 301, 16, 128, False)])
def test_stacked_lookup_grads_match_jax(t, v, k, n, zipf):
    rs = np.random.RandomState(v)
    stack = rs.randn(t, v, k).astype(np.float32)
    w_cols = rs.randn(t, v).astype(np.float32)
    if zipf:
        ids = np.minimum(rs.zipf(1.2, size=(t, n)) + 1, v - 1).astype(np.int32)
    else:
        ids = rs.randint(0, v, size=(t, n)).astype(np.int32)
    cot = rs.randn(t, n, k + 1).astype(np.float32)

    def jloss(s, w):
        rows = jax_emb.packed_lookup_stacked_split(s, w, [jnp.asarray(i) for i in ids])
        return sum(jnp.sum(r * c) for r, c in zip(rows, cot))

    with jax_emb.fused_grad(True), jax_emb.grad_kernel("segmat"):
        rows_ref = jax_emb.packed_lookup_stacked_split(
            jnp.asarray(stack), jnp.asarray(w_cols), [jnp.asarray(i) for i in ids])
        d_stack_ref, d_w_ref = jax.grad(jloss, argnums=(0, 1))(
            jnp.asarray(stack), jnp.asarray(w_cols))

    s_t = torch.from_numpy(stack).requires_grad_()
    w_t = torch.from_numpy(w_cols).requires_grad_()
    rows = torch_emb.packed_lookup_stacked_split(s_t, w_t, [torch.from_numpy(i) for i in ids])
    assert len(rows) == t
    for r, rr in zip(rows, rows_ref):
        np.testing.assert_array_equal(r.detach().numpy(), np.asarray(rr))
    sum((r * torch.from_numpy(c)).sum() for r, c in zip(rows, cot)).backward()
    for got, ref in ((s_t.grad, d_stack_ref), (w_t.grad, d_w_ref)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()
        np.testing.assert_array_equal(got.numpy() == 0, ref == 0)
