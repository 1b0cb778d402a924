"""Operations and bytes of xDeepFM's work, from the configuration's shapes.

Each function takes the configuration and a count of rows ``n`` and
returns (operations, bytes) for that work on ``n`` rows: each input byte
read once and each output byte written once (float32 unless said), and
the operations the algorithm needs, whatever kernel does them.
"""

from __future__ import annotations

F32 = 4


def _dims(cfg):
    hp, d = cfg["hparams"], cfg["data"]
    return hp["embedding_size"], d["n_cat"], list(hp["cin_cross_layer_units"])


def _cin_layers(cfg):
    """(fan-in H_i, maps O_i) of each CIN layer."""
    _, h0, units = _dims(cfg)
    out, hk = [], h0
    for o in units:
        out.append((hk, o))
        hk = o // 2
    return out


def _final(cfg):
    units = _dims(cfg)[2]
    return sum(o // 2 for o in units[:-1]) + units[-1]


def _cin_weights(cfg):
    h0 = _dims(cfg)[1]
    return sum(h0 * hk * o + o for hk, o in _cin_layers(cfg))


def cin_fwd(cfg, n):
    """The CIN tower's forward to the pooled maps: per layer the products
    x0[h] * x_i[m] and the contraction with W_i (2 operations a
    multiply-add) at every (row, position). Reads x0 and the weights,
    writes the pooled (n, final) maps."""
    k, h0, _ = _dims(cfg)
    ops = sum(n * k * h0 * hk * (1 + 2 * o) for hk, o in _cin_layers(cfg))
    return ops, F32 * (n * k * h0 + _cin_weights(cfg) + n * _final(cfg))


def cin_fwd_save(cfg, n):
    """``cin_fwd``, also writing every layer's maps (O_i, n * k) for the
    backward."""
    k = _dims(cfg)[0]
    ops, nbytes = cin_fwd(cfg, n)
    return ops, nbytes + F32 * n * k * sum(o for _, o in _cin_layers(cfg))


def cin_bwd(cfg, n):
    """The CIN tower's backward from the pooled maps' gradient to dx0, dW_i
    and db_i on saved maps: per layer the products again, dW = z g^T and
    u = W g (2 operations a multiply-add each), and dx0 and dx_i from u (2
    each). Reads x0, the saved maps, the pooled gradient and the weights;
    writes dx0 and the weights' gradients."""
    k, h0, _ = _dims(cfg)
    ops = sum(n * k * h0 * hk * (1 + 4 * o + 4) for hk, o in _cin_layers(cfg))
    maps = sum(o for _, o in _cin_layers(cfg))
    reads = n * k * h0 + n * k * maps + n * _final(cfg) + _cin_weights(cfg)
    return ops, F32 * (reads + n * k * h0 + _cin_weights(cfg))


def segment_sum(cfg, n):
    """The tables' gradients from one batch's lookups: per hashed field the
    n rows of C = k + 1 columns (the table's k and the linear weight)
    summed by id into a dense (buckets + 1, C) gradient. Reads the sorted
    ids and the rows, writes every table's gradient."""
    k, f, _ = _dims(cfg)
    c, v = k + 1, cfg["num_buckets"] + 1
    return f * n * c, F32 * (f * n + f * n * c) + F32 * f * c * v


def model_flops(cfg, n):
    """The model's forward operations on n rows: the CIN's products and
    contractions and the DNN's matrix products (2 a multiply-add); the
    embedding gathers and the linear tower count none."""
    k, h0, _ = _dims(cfg)
    hp, d = cfg["hparams"], cfg["data"]
    dims = [h0 * k + d["n_dense"], *hp["deep_hidden_units"], 1]
    dnn = sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return cin_fwd(cfg, n)[0] + n * dnn, 0
