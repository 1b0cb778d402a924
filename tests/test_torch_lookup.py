"""K6's plain twin (recman_tpu_torch/ops/segment_matmul.py) and the
lookups' custom backward (recman_tpu_torch/ops/embedding.py) against the
JAX package on the CPU.

The reference side of K6 is ``_segment_matmul_from_sorted`` run in Pallas
interpret mode; the lookups run under ``fused_grad(True)`` and the same
``grad_kernel`` on both sides. Tolerance 1e-6 of the largest grad: both
sides sum the same f32 cotangents per id in another order (the twin
exactly, through float64 prefix sums); rows no id falls in are exactly 0
on both.
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


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    np.testing.assert_array_equal(got == 0, ref == 0)


def _genres_ids(rs, b=128, l=19, v=20):
    """ML-100K's genres geometry: (B, 19) padded tag ids, PAD (-1) clamped
    to 0 by the packed layer, so id 0 takes most rows."""
    ids = np.full((b, l), -1)
    for i in range(b):
        k = rs.randint(1, 4)
        ids[i, :k] = rs.choice(np.arange(1, v), k, replace=False)
    return np.maximum(ids, 0).reshape(-1)


def _k6_case(name, rs):
    if name == "hot id":
        ids = np.where(rs.rand(300) < 0.8, 7, rs.randint(0, 50, 300))
        return ids, 50, 9
    if name == "empty rows":
        return rs.choice([3, 11, 40], 64), 300, 5
    if name == "id at V-1":
        return np.r_[rs.randint(0, 99, 40), [99, 99, 99]], 100, 17
    if name == "N not a multiple of 8":
        return rs.randint(0, 30, 77), 30, 3
    if name == "genres":
        return _genres_ids(rs), 20, 9
    raise ValueError(name)


K6_CASES = ["hot id", "empty rows", "id at V-1", "N not a multiple of 8", "genres"]


@pytest.mark.parametrize("name", K6_CASES)
def test_k6_twin_matches_jax_interpret(name):
    rs = np.random.RandomState(len(name))
    ids, v, c = _k6_case(name, rs)
    sids = np.sort(ids.astype(np.int32))
    sg = rs.randn(len(ids), c).astype(np.float32)
    ref = jax_emb._segment_matmul_from_sorted(jnp.asarray(sids), jnp.asarray(sg), v,
                                              interpret=True)
    got = segment_matmul.segment_matmul_from_sorted(torch.from_numpy(sids),
                                                     torch.from_numpy(sg), v).numpy()
    _close(got, ref)
    absent = np.setdiff1d(np.arange(v), sids)
    assert (got[absent] == 0).all()
    if name == "genres":
        assert np.bincount(sids).max() > len(sids) // 2  # the longest-run case


def test_k6_twin_ignores_ids_outside_the_vocab():
    sids = torch.tensor([-3, -1, 0, 2, 2, 5, 9], dtype=torch.int32)
    sg = torch.arange(1, 8, dtype=torch.float32)[:, None].repeat(1, 2)
    got = segment_matmul.segment_matmul_rows_reference(sids, sg, 5)
    assert got.shape == (5, 2) and got.is_contiguous()
    assert got[:, 0].tolist() == [3.0, 0.0, 9.0, 0.0, 0.0]
    assert torch.equal(got[:, 0], got[:, 1])


def test_k6_cpu_path_counts_no_launch():
    before = (segment_matmul.ROWS_LAUNCHES, segment_matmul.LAUNCHES)
    segment_matmul.segment_matmul_from_sorted(torch.zeros(8, dtype=torch.int32),
                                              torch.ones(8, 3), 4)
    assert (segment_matmul.ROWS_LAUNCHES, segment_matmul.LAUNCHES) == before


@pytest.mark.parametrize(
    "sids,sg,v,match",
    [
        (torch.zeros(8, dtype=torch.int64), torch.zeros((8, 3)), 10, "int32"),
        (torch.zeros(8, dtype=torch.int32), torch.zeros((8, 3), dtype=torch.float64), 10, "float32"),
        (torch.zeros(7, dtype=torch.int32), torch.zeros((8, 3)), 10, "do not match"),
        (torch.zeros(16, dtype=torch.int32)[::2], torch.zeros((8, 3)), 10, "contiguous"),
        (torch.zeros(8, dtype=torch.int32), torch.zeros((3, 8)).t(), 10, "contiguous"),
        (torch.zeros(8, dtype=torch.int32), torch.zeros((8, 257)), 10, "C <= 256"),
    ],
)
def test_k6_wrapper_rejects_bad_arguments(sids, sg, v, match):
    with pytest.raises(ValueError, match=match):
        segment_matmul._segment_matmul_rows_cuda(sids, sg, v)


def test_segmat_multi_gate_matches_the_reference_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert torch_emb._segmat_multi_active(9, cuda) and not torch_emb._segmat_multi_active(7, cuda)
    assert not torch_emb._segmat_multi_active(17, cpu)
    with torch_emb.grad_kernel("segmat"):
        assert torch_emb._segmat_multi_active(1, cpu)
    with torch_emb.grad_kernel("scatter"):
        assert not torch_emb._segmat_multi_active(17, cuda)
    assert torch_emb._fused_active(cuda) and not torch_emb._fused_active(cpu)
    with torch_emb.fused_grad(True):
        assert torch_emb._fused_active(cpu)
    with torch_emb.fused_grad(False):
        assert not torch_emb._fused_active(cuda)
    with pytest.raises(AssertionError):
        with torch_emb.grad_kernel("atomic"):
            pass


def test_lookup_is_plain_autograd_when_the_fused_backward_is_off():
    table = torch.randn(10, 4, requires_grad=True)
    ids = torch.tensor([[1, 2], [3, 1]])

    def gather_node(rows):  # the node under the reshape's view
        return type(rows.grad_fn.next_functions[0][0]).__name__

    assert "IndexSelect" in gather_node(torch_emb.embedding_lookup(table, ids))
    with torch_emb.fused_grad(True):
        rows = torch_emb.embedding_lookup(table, ids)
    assert rows.shape == (2, 2, 4) and "_Lookup" in gather_node(rows)


def _lookup_grad_jax(kind, table, ids, cot):
    def loss(t):
        return jnp.sum(jax_emb.embedding_lookup(t, jnp.asarray(ids)) * cot)

    with jax_emb.fused_grad(True), jax_emb.grad_kernel(kind):
        return jax.grad(loss)(jnp.asarray(table))


@pytest.mark.parametrize("kind", ["segmat", "scatter"])
@pytest.mark.parametrize("geometry", ["user_id", "genres"])
def test_embedding_lookup_table_grad_matches_jax(kind, geometry):
    rs = np.random.RandomState(5)
    if geometry == "genres":
        ids, v = _genres_ids(rs).reshape(128, 19), 20
    else:
        ids, v = rs.randint(0, 944, 128), 944
    table = rs.randn(v, 9).astype(np.float32)
    cot = rs.randn(*ids.shape, 9).astype(np.float32)
    ref = _lookup_grad_jax(kind, table, ids, cot)
    t = torch.from_numpy(table).requires_grad_()
    with torch_emb.fused_grad(True), torch_emb.grad_kernel(kind):
        rows = torch_emb.embedding_lookup(t, torch.from_numpy(ids))
        (rows * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(rows.detach().numpy(), table[ids])
    _close(t.grad.numpy(), ref)


@pytest.mark.parametrize("k,kind", [(8, "auto"), (8, "segmat"), (1, "auto"), (1, "scatter")])
def test_embedding_lookup_grouped_matches_jax(k, kind):
    """Two same-shape tables (one batched backward: K3's twin at C >= 8
    under "segmat", per-table scatters otherwise on the CPU) beside a
    singleton, against the reference's grouped lookup."""
    rs = np.random.RandomState(k)
    shapes = [(40, k), (40, k), (25, k)]
    tables = [rs.randn(*s).astype(np.float32) for s in shapes]
    ids = [np.minimum(rs.zipf(1.3, 96), s[0] - 1) for s in shapes]
    cots = [rs.randn(96, k).astype(np.float32) for _ in shapes]

    def jloss(ts):
        rows = jax_emb.embedding_lookup_grouped(list(ts), [jnp.asarray(i) for i in ids])
        return sum(jnp.sum(r * c) for r, c in zip(rows, cots))

    with jax_emb.fused_grad(True), jax_emb.grad_kernel(kind):
        refs = jax.grad(jloss)([jnp.asarray(t) for t in tables])
    ts = [torch.from_numpy(t).requires_grad_() for t in tables]
    before = segment_matmul.LAUNCHES
    with torch_emb.fused_grad(True), torch_emb.grad_kernel(kind):
        rows = torch_emb.embedding_lookup_grouped(ts, [torch.from_numpy(i) for i in ids])
        assert "_LookupMulti" in type(rows[0].grad_fn.next_functions[0][0]).__name__
        sum((r * torch.from_numpy(c)).sum() for r, c in zip(rows, cots)).backward()
    assert segment_matmul.LAUNCHES == before
    for t, ref in zip(ts, refs):
        _close(t.grad.numpy(), ref)


@pytest.mark.parametrize("kind", ["segmat", "scatter"])
def test_stacked_lookup_backward_honours_the_gate(kind):
    rs = np.random.RandomState(9)
    t, v, k, n = 3, 30, 4, 50
    stack = rs.randn(t, v, k).astype(np.float32)
    w_cols = rs.randn(t, v).astype(np.float32)
    ids = rs.randint(0, v, (t, n)).astype(np.int32)
    cot = rs.randn(t, n, k + 1).astype(np.float32)

    def jloss(s, w):
        rows = jax_emb.packed_lookup_stacked_split(s, w, [jnp.asarray(i) for i in ids])
        return sum(jnp.sum(r * c) for r, c in zip(rows, cot))

    with jax_emb.fused_grad(True), jax_emb.grad_kernel(kind):
        refs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(stack), jnp.asarray(w_cols))
    s_t = torch.from_numpy(stack).requires_grad_()
    w_t = torch.from_numpy(w_cols).requires_grad_()
    with torch_emb.grad_kernel(kind):
        rows = torch_emb.packed_lookup_stacked_split(s_t, w_t, [torch.from_numpy(i) for i in ids])
        sum((r * torch.from_numpy(c)).sum() for r, c in zip(rows, cot)).backward()
    for got, ref in ((s_t.grad, refs[0]), (w_t.grad, refs[1])):
        _close(got.numpy(), ref)


def test_the_route_is_fixed_when_the_forward_runs(monkeypatch):
    """Autograd runs a CUDA backward on a thread of its own, where the
    thread-local contexts are unset: the backward takes the route that was
    set when its forward ran."""
    import threading

    calls = []
    real = torch_emb.segment_matmul_from_sorted
    monkeypatch.setattr(torch_emb, "segment_matmul_from_sorted",
                        lambda *a: calls.append(threading.get_ident()) or real(*a))
    table = torch.randn(20, 9, requires_grad=True)
    with torch_emb.fused_grad(True), torch_emb.grad_kernel("segmat"):
        rows = torch_emb.embedding_lookup(table, torch.tensor([3, 3, 7]))
    worker = threading.Thread(target=lambda: rows.sum().backward())
    worker.start()
    worker.join()
    assert len(calls) == 1 and calls[0] != threading.get_ident()
    assert table.grad[3].tolist() == [2.0] * 9 and table.grad[7].tolist() == [1.0] * 9
