"""K6's and K7's plain twins (recman_tpu_torch/ops/segment_matmul.py) and
the lookups' custom backward (recman_tpu_torch/ops/embedding.py) against
the JAX package on the CPU.

The reference side of K6 and K7 is ``_segment_matmul_from_sorted`` and
``_segment_matmul_from_sorted_batched_vk`` run in Pallas interpret mode;
the lookups run under ``fused_grad(True)`` and the same ``grad_kernel``
(and ``SEGMAT_VK_OUT``) on both sides. Tolerance 1e-6 of the largest grad
(K7's twin 1e-5: the interpreted kernel sums a tile's ids through f32
one-hot products): both sides sum the same f32 cotangents per id in
another order (the twin exactly, through float64 prefix sums); rows no id
falls in are exactly 0 on both. xDeepFM under ``split_lookup("on")``
against ``"off"``: the reference's own bounds (tests/test_ops.py), loss
1e-6 relative, gradients 1e-4 relative and 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from recman_tpu.ops import embedding as jax_emb
from recman_tpu_torch.ops import embedding as torch_emb
from recman_tpu_torch.ops import segment_matmul
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

TOL = 1e-6


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
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
    if name == "C 300":  # past the first port's C <= 256
        return np.minimum(rs.zipf(1.2, 200) - 1, 63), 64, 300
    raise ValueError(name)


K6_CASES = ["hot id", "empty rows", "id at V-1", "N not a multiple of 8", "genres", "C 300"]


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


@pytest.mark.parametrize("name", ["genres", "hot id"])
def test_k6_twin_is_k7_twin_at_one_table(name):
    """K6 is K7 at T = 1 on the transposed cotangents (k_emb = C, n_vec =
    0): the twins agree bit for bit, as the kernels must on the card."""
    rs = np.random.RandomState(len(name))
    ids, v, c = _k6_case(name, rs)
    sids = torch.from_numpy(np.sort(ids.astype(np.int32)))
    sg = torch.from_numpy(rs.randn(len(ids), c).astype(np.float32))
    k6 = segment_matmul.segment_matmul_from_sorted(sids, sg, v)
    emb, vec = segment_matmul.segment_matmul_from_sorted_batched_vk(
        sids[None], sg.t().contiguous()[None], v, c, 0)
    assert vec.shape == (1, 0, v) and torch.equal(k6, emb[0])


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
        (torch.zeros(0, dtype=torch.int32), torch.zeros((0, 3)), 10, "nonempty"),
        (torch.zeros(8, dtype=torch.int32), torch.zeros((8, 3)), 0, "nonempty"),
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


# -- K7 and the split lookup ----------------------------------------------------

K7_CASES = [  # (T, k_emb, n_vec, N, V)
    (3, 4, 1, 70, 50),
    (2, 16, 1, 300, 1001),   # the bench's k_emb and n_vec
    (2, 5, 2, 129, 33),      # bias and w columns; N not a multiple of 8
    (1, 3, 0, 40, 9),        # no vector columns
]


@pytest.mark.parametrize("t,k_emb,n_vec,n,v", K7_CASES)
def test_k7_twin_matches_jax_interpret(t, k_emb, n_vec, n, v):
    rs = np.random.RandomState(n + v)
    ids = np.minimum(rs.zipf(1.3, (t, n)) - 1, v - 1)
    ids[:, :3] = v - 1  # the last id, at a tile edge
    sids = np.sort(ids, axis=1).astype(np.int32)
    sg_t = rs.randn(t, k_emb + n_vec, n).astype(np.float32)
    ref_emb, ref_vec = jax_emb._segment_matmul_from_sorted_batched_vk(
        jnp.asarray(sids), jnp.asarray(sg_t), v, k_emb, n_vec, interpret=True)
    before = segment_matmul.VK_LAUNCHES
    emb, vec = segment_matmul.segment_matmul_from_sorted_batched_vk(
        torch.from_numpy(sids), torch.from_numpy(sg_t), v, k_emb, n_vec)
    assert segment_matmul.VK_LAUNCHES == before  # the CPU runs the twin
    _close(emb.numpy(), ref_emb, 1e-5)
    if n_vec:
        _close(vec.numpy(), ref_vec, 1e-5)
    assert vec.shape == (t, n_vec, v)
    for i in range(t):
        assert (emb[i, np.setdiff1d(np.arange(v), sids[i])] == 0).all()


def _split_case(rs):
    """Two same-shape (40, 5) tables, a singleton (25, 5), each with a w
    column and a bias column, and 64 Zipf ids each."""
    shapes = [(40, 5), (40, 5), (25, 5)]
    tables = [rs.randn(*sh).astype(np.float32) for sh in shapes]
    vecs = [tuple(rs.randn(sh[0]).astype(np.float32) for _ in range(2)) for sh in shapes]
    ids = [np.minimum(rs.zipf(1.3, 64), sh[0] - 1) for sh in shapes]
    cots = [rs.randn(64, 7).astype(np.float32) for _ in shapes]
    return tables, vecs, ids, cots


ROUTES = {"vk": ("segmat", True), "segmat": ("segmat", False), "scatter": ("scatter", False)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_packed_lookup_grouped_matches_jax(route, monkeypatch):
    """Rows and every table and vector gradient of the split lookup on
    each backward route (K7's twin, K3's twin, per-table scatters) against
    the reference's ``packed_lookup_grouped`` on the same route."""
    kind, vk = ROUTES[route]
    monkeypatch.setattr(jax_emb, "SEGMAT_VK_OUT", vk)
    monkeypatch.setattr(torch_emb, "SEGMAT_VK_OUT", vk)
    tables, vecs, ids, cots = _split_case(np.random.RandomState(21))

    def jloss(ts, vs):
        rows = jax_emb.packed_lookup_grouped(list(ts), list(vs), [jnp.asarray(i) for i in ids])
        return sum(jnp.sum(r * c) for r, c in zip(rows, cots)), rows

    with jax_emb.fused_grad(True), jax_emb.grad_kernel(kind):
        (_, jrows), (gt, gv) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            [jnp.asarray(t) for t in tables], [tuple(jnp.asarray(x) for x in v) for v in vecs])
    ts = [torch.from_numpy(t).requires_grad_() for t in tables]
    vs = [tuple(torch.from_numpy(x).requires_grad_() for x in v) for v in vecs]
    calls = {"vk": 0, "segmat": 0}
    for name, key in (("segment_matmul_from_sorted_batched_vk", "vk"),
                      ("segment_matmul_from_sorted_batched", "segmat")):
        real = getattr(torch_emb, name)
        monkeypatch.setattr(torch_emb, name,
                            lambda *a, _r=real, _k=key: calls.__setitem__(_k, calls[_k] + 1) or _r(*a))
    with torch_emb.fused_grad(True), torch_emb.grad_kernel(kind):
        rows = torch_emb.packed_lookup_grouped(ts, vs, [torch.from_numpy(i) for i in ids])
    sum((r * torch.from_numpy(c)).sum() for r, c in zip(rows, cots)).backward()
    assert calls == {"vk": int(route == "vk"), "segmat": int(route == "segmat")}
    for r, jr, t in zip(rows, jrows, tables):
        np.testing.assert_array_equal(r.detach().numpy(), np.asarray(jr))
    for t, ref in zip(ts, gt):
        _close(t.grad.numpy(), ref)
    for v, refs in zip(vs, gv):
        for x, ref in zip(v, refs):
            _close(x.grad.numpy(), ref)


@pytest.mark.parametrize("kind", ["segmat", "scatter"])
def test_one_concat_stacked_lookup_matches_the_split_concat(kind):
    """The one-concat stacked form (``packed_lookup_stacked`` over a (T, V,
    k + 1) concat, ``STACKED_SPLIT_CONCAT = False``) gives the split-concat
    form's rows and gradients, bit for bit, and the reference's."""
    rs = np.random.RandomState(10)
    t, v, k, n = 3, 30, 4, 50
    stack = rs.randn(t, v, k).astype(np.float32)
    w_cols = rs.randn(t, v).astype(np.float32)
    ids = [rs.randint(0, v, n).astype(np.int32) for _ in range(t)]
    cot = rs.randn(t, n, k + 1).astype(np.float32)

    def jloss(s, w):
        packed = jnp.concatenate([s, w[:, :, None]], axis=2)
        rows = jax_emb.packed_lookup_stacked(packed, [jnp.asarray(i) for i in ids])
        return sum(jnp.sum(r * c) for r, c in zip(rows, cot))

    with jax_emb.fused_grad(True), jax_emb.grad_kernel(kind):
        refs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(stack), jnp.asarray(w_cols))
    grads, all_rows = [], []
    for one_concat in (True, False):
        s_t = torch.from_numpy(stack.copy()).requires_grad_()
        w_t = torch.from_numpy(w_cols.copy()).requires_grad_()
        with torch_emb.grad_kernel(kind):
            id_list = [torch.from_numpy(i) for i in ids]
            if one_concat:
                rows = torch_emb.packed_lookup_stacked(torch.cat([s_t, w_t[:, :, None]], 2), id_list)
            else:
                rows = torch_emb.packed_lookup_stacked_split(s_t, w_t, id_list)
            sum((r * torch.from_numpy(c)).sum() for r, c in zip(rows, cot)).backward()
        grads.append((s_t.grad, w_t.grad))
        all_rows.append(torch.stack(rows).detach())
    assert torch.equal(all_rows[0], all_rows[1])
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    _close(grads[0][0].numpy(), refs[0])
    _close(grads[0][1].numpy(), refs[1])


@pytest.fixture
def port_synthetic(synthetic_df):
    """The reference's synthetic schema built with the port's features: two
    same-shape sparse tables, a singleton and a multi-valued field."""
    from recman_tpu_torch.features import FeatureSet, MultiValCsvFeat, SparseFeat
    from recman_tpu_torch.models import XDeepFM

    df = synthetic_df
    fs = FeatureSet()
    for name in ("USER_ID", "CLASS_ID", "CATEGORY"):
        fs[name] = SparseFeat(name, feat_size=len(np.unique(df[name].values)))
    fs["HISTORICAL_CATEGORIES"] = MultiValCsvFeat("HISTORICAL_CATEGORIES", tags=("a", "b", "c", "d"))
    fs.initialize(df)
    batch = {k: torch.as_tensor(v) for k, v in fs.transform(df, y=df["LABEL"].values).items()}
    return XDeepFM(fs), batch


@pytest.mark.parametrize("route", list(ROUTES))
def test_xdeepfm_split_lookup_matches_concat(port_synthetic, route, monkeypatch):
    """The whole model's loss and gradients under ``split_lookup("on")``
    against ``"off"``, as tests/test_ops.py holds the reference, on each
    backward route of the split form."""
    model, batch = port_synthetic
    kind, vk = ROUTES[route]
    monkeypatch.setattr(torch_emb, "SEGMAT_VK_OUT", vk)
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    results = []
    for mode in ("on", "off"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        with torch_emb.fused_grad(True), torch_emb.grad_kernel(kind), torch_emb.split_lookup(mode):
            loss = model.loss(leaves, batch, training=False)
        loss.backward()
        results.append((loss.item(), {k: v.grad for k, v in leaves.items()}))
    (l_split, g_split), (l_concat, g_concat) = results
    assert l_split == pytest.approx(l_concat, rel=1e-6)
    for name in g_concat:
        np.testing.assert_allclose(g_split[name].numpy(), g_concat[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_split_lookup_auto_is_off_as_in_the_reference():
    assert not torch_emb.SPLIT_LOOKUP_AUTO_TPU and not torch_emb.SEGMAT_VK_OUT
    assert not torch_emb._split_lookup_active("cpu")
    with torch_emb.split_lookup("on"):
        assert torch_emb._split_lookup_active("cpu")
        with torch_emb.split_lookup("off"):
            assert not torch_emb._split_lookup_active("cpu")
