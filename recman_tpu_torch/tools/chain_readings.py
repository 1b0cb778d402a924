"""Readings of the CIN kernels on one CUDA GPU, beside what chip_smoke.py
checks. Each reading is one JSON line on stdout.

- ``accuracy``: at every chain geometry of tests/test_torch_cuda_kernels.py
  and chip_smoke.py, per activation and input seed, K1's pooled blocks and
  fmaps (the save form) end to end against its f32 twin
  (``cin_chain_fm_reference``), and both against the exact chain: the same
  formulas and bf16 roundings with the sums in f64 (every product of two
  bf16 values is exact there). Sums in another order round a feed element
  to the neighbouring bf16 value now and then, and the next layers carry
  it, so the gap between two f32 orders is read beside each one's gap to
  the exact chain. ``smoke_edges`` (also part of ``k1_accuracy``) is its
  reading of chip_smoke.py's edges alone, at two seeds.
- ``dw_accuracy`` (also part of ``accuracy``): the tensor cores'
  accumulation in K2 (both forms), K4 and K5, at the card tests' chain
  and layer geometries. Each kernel's output is read against the exact
  sums, the same formulas and bf16 roundings with the sums in f64, beside
  the plain twin's gap to the same sums: K4's output, K5's dx0, dxk and
  dW, and K2's dW layer by layer. Each side of K2 is read on the fmaps
  it reads: the save form and its twin on K1's saved fmaps (which the
  recompute form rebuilds bit for bit), the recompute twin on its own
  rebuilt fmaps. ``near_exact`` is the bound the card tests hold a sum
  to (within 2x of the twin's gap, or under 1e-7 of max|exact|); on the
  lower layers of K2, bf16 roundings of gpre and of the feeds lead both
  gaps, so only the final layer's dW is held to it.
- ``timing``: K1, K2 (both forms), K4 and K5 at the main paths' shapes
  (CUDA events, median of back-to-back calls), K4 in turns with builds
  of its other splits (``K4_SPLITS``; 0 is one accumulation, the cost of
  its split), and the peak memory that each form of K2 allocates over
  its inputs at batch 65,536.

Run from the repository root:

    python -m recman_tpu_torch.tools.chain_readings accuracy timing
    python -m recman_tpu_torch.tools.chain_readings dw_accuracy

or, to read another checkout's kernels with this script,
``PYTHONPATH=<checkout> python <this file> timing``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

# (H0, units, B, D, seeds): the card tests' chain geometries with the seeds
# of test_k1_save_and_k2_match_plain_versions (13) and
# test_k2_recompute_is_bit_equal_to_the_save_form (17), then chip_smoke.py's
# (7 at its small and full geometry, 8 at the large batch)
ACCURACY_CASES = [
    (6, (4,), 64, 4, (13, 17)),
    (6, (8, 6), 16, 16, (13, 17)),
    (5, (6, 4), 128, 1, (13, 17)),
    (7, (10, 8, 6), 8, 128, (13, 17)),
    (39, (256, 128), 128, 8, (13, 17)),
    (128, (128, 64), 128, 8, (13, 17)),
    (6, (100, 100, 100), 128, 8, (13, 17)),
    (26, (100, 100), 512, 16, (13, 17)),
    (26, (100, 100), 8192, 16, (13, 17, 7)),
    (5, (6, 4), 64, 4, (7,)),
    (26, (100, 100), 65_536, 16, (17, 8)),
    # the card tests' geometries at the edges of the chain's range
    (26, (256, 256, 256), 64, 16, (13, 17)),
    (26, (100, 257), 64, 16, (13, 17)),
    (128, (256, 256), 16, 8, (13, 17)),
    (128, (256, 512), 16, 8, (13, 17)),
    (26, (100, 100), 4, 256, (13, 17)),
    (6, (8, 6), 2, 1024, (13, 17)),
    (6, (16,) * 8 + (10,), 32, 4, (13, 17)),
]
ACTS = ("identity", "relu", "leaky_relu")
# chip_smoke.py's CHAIN_EDGES (H0, units, B, D), read at its seed (7) and
# a second one (8), at its activation (leaky_relu)
SMOKE_EDGES = [(26, (100, 257), 8192, 16), (128, (256, 256), 8192, 8), (26, (256, 512), 2048, 16),
               (26, (100, 100), 256, 256), (26, (100,) * 9, 1024, 16),
               (26, (256, 256, 256), 8192, 16)]
SMOKE_SEEDS = (7, 8)

# tests/test_torch_cuda_kernels.py's geometries: CHAIN_CASES (inputs seed
# 13, cotangents seed 5) and INTERACT_CASES (seed h0 + hk + o)
K2_CASES = [
    (6, (4,), 64, 4),
    (6, (8, 6), 16, 16),
    (5, (6, 4), 128, 1),
    (7, (10, 8, 6), 8, 128),
    (39, (256, 128), 128, 8),
    (128, (128, 64), 128, 8),
    (6, (100, 100, 100), 128, 8),
    (26, (100, 100), 512, 16),
    (26, (100, 100), 8192, 16),
    (26, (256, 256, 256), 64, 16),
    (26, (100, 257), 64, 16),
    (128, (256, 256), 16, 8),
    (128, (256, 512), 16, 8),
    (26, (100, 100), 4, 256),
    (6, (8, 6), 2, 1024),
    (6, (16,) * 8 + (10,), 32, 4),
]
INTERACT_CASES = [
    (5, 3, 8, 64),
    (5, 40, 8, 8),
    (7, 5, 9, 301),
    (26, 26, 200, 40_960),
    (26, 100, 200, 40_960),
    (26, 100, 300, 1000),
    (3, 128, 512, 130),
    (130, 1, 4, 200),
    (5, 13, 40, 999),
    (26, 100, 257, 40_960),
    (26, 100, 264, 4_096),
    (26, 100, 200, 40),
]


def emit(**kv):
    print(json.dumps(kv), flush=True)


def chain_inputs(h0, units, b, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    x0c = torch.randn((h0, b * d), generator=g)
    ws, bs, hk = [], [], h0
    for o in units:
        ws.append(torch.randn((h0 * hk, o), generator=g) * (2.0 / (h0 * hk + o)) ** 0.5)
        bs.append(0.1 * torch.randn((o,), generator=g))
        hk = o // 2
    return x0c.to(device), [w.to(device) for w in ws], [v.to(device) for v in bs]


def exact_chain(x0c, ws, bs, units, d, act):
    """The chain with K1's bf16 roundings and f64 sums: pooled blocks, then
    fmaps, all f64."""
    from recman_tpu_torch.ops import cin_chain

    h0, bd = x0c.shape
    x0b = x0c.to(torch.bfloat16)
    xkb = x0b
    outs, fmaps = [], []
    for i, (w, bias, o) in enumerate(zip(ws, bs, units)):
        z = (x0b[:, None, :] * xkb[None, :, :]).reshape(h0 * xkb.shape[0], bd).double()
        fmap = cin_chain._act(act, w.to(torch.bfloat16).double().t() @ z + bias.double()[:, None])
        del z
        fmaps.append(fmap)
        if i != len(units) - 1:
            xkb, direct = fmap[: o // 2].float().to(torch.bfloat16), fmap[o // 2:]
        else:
            direct = fmap
        outs.append(direct.reshape(direct.shape[0], bd // d, d).sum(2).t())
    return outs, fmaps


def rel(refs, gots):
    """max |ref - got| / max |ref| per tensor (0 where ref is all zero)."""
    out = []
    for r, g in zip(refs, gots):
        scale = r.abs().max().item()
        out.append((r.double() - g.double()).abs().max().item() / scale if scale else 0.0)
    return out


def exact_chain_bwd(x0c, ws, gs, fmaps, units, d, act):
    """K2's dW_i with its bf16 roundings (z, W, gpre) and f64 sums, from
    ``fmaps`` (f32 or f64): ``cin_chain_bwd_reference``'s formulas."""
    from recman_tpu_torch.ops import cin_chain

    h0, bd = x0c.shape
    cfgs = cin_chain._layer_cfgs(h0, units)
    x0b = x0c.to(torch.bfloat16)
    dws, dxk_next = [None] * len(cfgs), None
    for i in reversed(range(len(cfgs))):
        cfg = cfgs[i]
        g_direct = gs[i].double().t().repeat_interleave(d, dim=1)
        dfmap = g_direct if cfg.final else torch.cat([dxk_next, g_direct], 0)
        deriv = cin_chain._act_deriv(act, fmaps[i].double())
        gpre = (dfmap if deriv is None else dfmap * deriv).to(torch.bfloat16).double()
        xk = x0c if i == 0 else fmaps[i - 1][: cfg.hk]
        z = (x0b[:, None, :] * xk.to(torch.bfloat16)[None, :, :]).reshape(h0 * cfg.hk, bd)
        dws[i] = z.double() @ gpre.t()
        del z
        if i:
            u = (ws[i].to(torch.bfloat16).double() @ gpre).reshape(h0, cfg.hk, bd)
            dxk_next = (u * x0c.double()[:, None, :]).sum(0)
            del u
    return dws


def exact_interact(x0c, xkc, w, g):
    """K4's output and K5's (dx0, dxk, dW) with their bf16 roundings and
    f64 sums: ``cin_interact_fm_reference``'s and
    ``cin_interact_fm_bwd_reference``'s formulas."""
    h0, bd = x0c.shape
    hk = xkc.shape[0]
    z = (x0c.to(torch.bfloat16)[:, None, :] * xkc.to(torch.bfloat16)[None, :, :]).reshape(
        h0 * hk, bd).double()
    wb = w.to(torch.bfloat16).double()
    gb = g.to(torch.bfloat16).double()
    pre = wb.t() @ z
    dw = z @ gb.t()
    del z
    u = (wb @ gb).reshape(h0, hk, bd)
    dx0 = (u * xkc.double()[None, :, :]).sum(1)
    dxk = (u * x0c.double()[:, None, :]).sum(0)
    return pre, (dx0, dxk, dw)


def near_exact(kernel_gap, twin_gap):
    """The bound on a tensor-core sum: its gap to the exact sums within
    twice the twin's, or under 1e-7 of max|exact| where the twin is closer
    still."""
    return kernel_gap <= 2 * twin_gap or kernel_gap < 1e-7


def _gaps(name, exact, kernel, twin):
    """A reading's kernel and twin gaps to the exact sums (max over the
    tensors of ``rel``) and their ratio."""
    k, t = max(rel(exact, kernel)), max(rel(exact, twin))
    return {f"{name}_kernel_exact": k, f"{name}_twin_exact": t,
            f"{name}_ratio": k / t if t else (0.0 if k == 0 else float("inf")),
            f"{name}_near_exact": near_exact(k, t)}


def _layer_gaps(name, exact, kernel, twin_gaps):
    """Per layer: the kernel's gap to ``exact``, the twin's (given), their
    ratio, and the bound on the final layer."""
    k = rel(exact, kernel)
    return {f"{name}_kernel_exact": k, f"{name}_twin_exact": twin_gaps,
            f"{name}_ratio": [a / b if b else (0.0 if a == 0 else float("inf"))
                              for a, b in zip(k, twin_gaps)],
            f"{name}_final_near_exact": near_exact(k[-1], twin_gaps[-1])}


class K2Case:
    """One chain geometry's backward against the exact sums: the inputs of
    the card tests (seed 13, cotangents seed 5), K1's saved fmaps (the bits
    both of K2's forms read: the recompute form rebuilds them with K1's
    code), the exact dW_i on them, and the twins' gaps, each twin against
    the exact sums on the fmaps it reads (the save twin K1's, the recompute
    twin its own rebuilt ones)."""

    def __init__(self, h0, units, b, d, act, device):
        from recman_tpu_torch.ops import cin_chain

        n = len(units)
        self.args = (h0, units, b, d, act)
        self.x0c, self.ws, self.bs = chain_inputs(h0, units, b, d, 13, device)
        self.fmaps = cin_chain.cin_chain_fwd(self.x0c, self.ws, self.bs, units, d, act,
                                             save=True)[n:]
        gen = torch.Generator().manual_seed(5)
        self.gs = [torch.randn((b, c.o - c.feed), generator=gen).to(device)
                   for c in cin_chain._layer_cfgs(h0, units)]
        self.exact = exact_chain_bwd(self.x0c, self.ws, self.gs, self.fmaps, units, d, act)
        twin = cin_chain.cin_chain_bwd_reference(self.x0c, self.ws, self.bs, self.gs,
                                                 self.fmaps, units, d, act)[1]
        self.twin = rel(self.exact, twin)
        del twin
        twin_fmaps = cin_chain.cin_chain_fm_reference(self.x0c, self.ws, self.bs, units, d, act,
                                                      save=True)[n:]
        exact = exact_chain_bwd(self.x0c, self.ws, self.gs, twin_fmaps, units, d, act)
        twin = cin_chain.cin_chain_bwd_recompute_reference(self.x0c, self.ws, self.bs, self.gs,
                                                           units, d, act)[1]
        self.twin_recompute = rel(exact, twin)
        del exact, twin, twin_fmaps

    def row(self):
        """The kernels' gaps per layer, both forms, beside the twins'."""
        from recman_tpu_torch.ops import cin_chain

        h0, units, b, d, act = self.args
        got = cin_chain.cin_chain_bwd(self.x0c, self.ws, self.bs, self.gs, self.fmaps, units,
                                      d, act)[1]
        row = _layer_gaps("k2_dw", self.exact, got, self.twin)
        got = cin_chain.cin_chain_bwd_recompute(self.x0c, self.ws, self.bs, self.gs, units, d,
                                                act)[1]
        row.update(_layer_gaps("k2_recompute_dw", self.exact, got, self.twin_recompute))
        return row


class InteractCase:
    """One layer geometry of K4 and K5 against the exact sums (the card
    tests' inputs, seed h0 + hk + o), with the twins' gaps."""

    def __init__(self, h0, hk, o, bd, device):
        from recman_tpu_torch.ops import cin_interact

        g = torch.Generator().manual_seed(h0 + hk + o)
        x0c = torch.randn((h0, bd), generator=g)
        xkc = torch.randn((hk, bd), generator=g)
        w = torch.randn((h0 * hk, o), generator=g) * (2.0 / (h0 * hk + o)) ** 0.5
        cot = torch.randn((o, bd), generator=g)
        self.inputs = tuple(t.to(device) for t in (x0c, xkc, w, cot))
        pre, grads = exact_interact(*self.inputs)
        self.exact = [pre, *grads]
        twin = [cin_interact.cin_interact_fm_reference(*self.inputs[:3]),
                *cin_interact.cin_interact_fm_bwd_reference(*self.inputs)]
        self.twin = rel(self.exact, twin)

    def row(self):
        from recman_tpu_torch.ops import cin_interact

        got = [cin_interact.cin_interact_fwd(*self.inputs[:3]),
               *cin_interact.cin_interact_bwd(*self.inputs)]
        row = {}
        for name, e, g, t in zip(("k4_out", "k5_dx0", "k5_dxk", "k5_dw"), self.exact, got,
                                 self.twin):
            k = rel([e], [g])[0]
            row.update({f"{name}_kernel_exact": k, f"{name}_twin_exact": t,
                        f"{name}_ratio": k / t if t else (0.0 if k == 0 else float("inf")),
                        f"{name}_near_exact": near_exact(k, t)})
        return row


def dw_accuracy(device):
    for h0, units, b, d in K2_CASES:
        for act in ACTS:
            case = K2Case(h0, units, b, d, act, device)
            emit(reading="dw_accuracy", kernel="K2", h0=h0, units=list(units), b=b, d=d, act=act,
                 **case.row())
            del case
            torch.cuda.empty_cache()
    for h0, hk, o, bd in INTERACT_CASES:
        case = InteractCase(h0, hk, o, bd, device)
        emit(reading="dw_accuracy", kernel="K4/K5", geometry=[h0, hk, o, bd], **case.row())
        del case
        torch.cuda.empty_cache()


# K4's other splits that ``timing`` reads beside the shipped one
K4_SPLITS = (0, 1, 2)
# Builds of K4 with another split of its tensor-core sums: kSplit k16
# steps per fresh fragment (0: one accumulation, the sums before the split)
SPLIT_FILES = {"kSplit": "cin_interact_fwd.cu"}
SPLIT_LIBS = ("cin_interact_fwd",)


def build_split(values, libs=SPLIT_LIBS):
    """Starts nvcc on a copy of csrc/ with each split constant of
    ``values`` ({"kSplit": 4, ...}) set; returns {library name: (path,
    process)}."""
    import re
    import shutil

    from recman_tpu_torch.ops import cuda_build

    root = cuda_build.BUILD_DIR / ("split-" + "-".join(f"{k}{v}" for k, v in values.items()))
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(cuda_build.CSRC, root)
    for name, value in values.items():
        path = root / SPLIT_FILES[name]
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          path.read_text())
        assert n == 1, name
        path.write_text(text)
    out = {}
    for lib in libs:
        path = root / f"lib{lib}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(path),
               str(root / f"{lib}.cu")]
        out[lib] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    return out


def load_split(procs):
    """The libraries of ``build_split`` once nvcc is done."""
    import ctypes

    libs = {}
    for lib, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{log}")
        emit(reading="build", library=str(path), ptxas=_ptxas(log))
        libs[lib] = ctypes.CDLL(str(path))
    return libs


def _ptxas(log):
    """ptxas's lines on each kernel's registers and spills."""
    return [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]


class use_build:
    """Within the block, the wrappers launch the given libraries' kernels
    ({library name: CDLL}) in place of this checkout's."""

    def __init__(self, libs):
        self.libs = libs

    def __enter__(self):
        from recman_tpu_torch.ops import cuda_build

        for name in self.libs:
            cuda_build.load(name)  # the shipped build, put back on exit
        self.saved = {name: cuda_build._libs[name] for name in self.libs}
        cuda_build._libs.update(self.libs)

    def __exit__(self, *exc):
        from recman_tpu_torch.ops import cuda_build

        cuda_build._libs.update(self.saved)


def accuracy(device):
    k1_accuracy(device)
    dw_accuracy(device)


def k1_accuracy(device):
    for h0, units, b, d, seeds in ACCURACY_CASES:
        for seed in seeds:
            for act in ("leaky_relu",) if b == 65_536 else ACTS:
                k1_reading(h0, units, b, d, seed, act, device)
    smoke_edges(device)


def smoke_edges(device):
    for h0, units, b, d in SMOKE_EDGES:
        for seed in SMOKE_SEEDS:
            k1_reading(h0, units, b, d, seed, "leaky_relu", device)


def k1_reading(h0, units, b, d, seed, act, device):
    from recman_tpu_torch.ops import cin_chain

    n = len(units)
    x0c, ws, bs = chain_inputs(h0, units, b, d, seed, device)
    got = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True)
    twin = cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True)
    apart = sum(int((f[: o // 2].to(torch.bfloat16) != t[: o // 2].to(torch.bfloat16)).sum())
                for f, t, o in zip(got[n:-1], twin[n:-1], units[:-1]))
    k1_twin = rel(twin, got)
    del twin
    ex_pool, ex_fmaps = exact_chain(x0c, ws, bs, units, d, act)
    exact = list(ex_pool) + list(ex_fmaps)
    k1_exact = rel(exact, got)
    twin = cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True)
    twin_exact = rel(exact, twin)
    del exact, twin, ex_pool, ex_fmaps
    emit(reading="accuracy", h0=h0, units=list(units), b=b, d=d, seed=seed, act=act,
         k1_twin=max(k1_twin), k1_exact=max(k1_exact), twin_exact=max(twin_exact),
         k1_twin_per_tensor=k1_twin, k1_exact_per_tensor=k1_exact,
         twin_exact_per_tensor=twin_exact, feed_elements_apart=apart,
         feed_elements=sum(o // 2 for o in units[:-1]) * b * d)
    torch.cuda.empty_cache()


def cuda_time_ms(fn, warmup=3, reps=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))


def peak_bytes(fn):
    """Bytes that fn() allocates at its peak over what was allocated before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def timing(device):
    from recman_tpu_torch.ops import cin_chain, cin_interact, cuda_build

    act = "leaky_relu"
    for b in (8192, 65_536):
        units = (100, 100)
        n = len(units)
        x0c, ws, bs = chain_inputs(26, units, b, 16, 7, device)
        out = cin_chain.cin_chain_fwd(x0c, ws, bs, units, 16, act, save=True)
        g = torch.Generator().manual_seed(11)
        gs = [torch.randn(p.shape, generator=g).to(device) for p in out[:n]]
        row = {"reading": "timing", "b": b}
        row["k1_ms"] = cuda_time_ms(lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, 16, act))
        row["k1_save_ms"] = cuda_time_ms(
            lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, 16, act, save=True))
        row["k2_ms"] = cuda_time_ms(
            lambda: cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[n:], units, 16, act))
        row["k2_recompute_ms"] = cuda_time_ms(
            lambda: cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, 16, act))
        row["k2_peak_bytes"] = peak_bytes(
            lambda: cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[n:], units, 16, act))
        row["k2_recompute_peak_bytes"] = peak_bytes(
            lambda: cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, 16, act))
        emit(**row)
        del x0c, ws, bs, out, gs
        torch.cuda.empty_cache()
    # K4 and K5 at the xDeepFM paper's Criteo layers 1-2 (B 4096, D 10)
    h0, hk, o, bd = 26, 100, 200, 40_960
    g = torch.Generator().manual_seed(17)
    x0c = torch.randn((h0, bd), generator=g).to(device)
    xkc = torch.randn((hk, bd), generator=g).to(device)
    w = (torch.randn((h0 * hk, o), generator=g) * (2.0 / (h0 * hk + o)) ** 0.5).to(device)
    cot = torch.randn((o, bd), generator=g).to(device)
    k4 = lambda: cin_interact.cin_interact_fwd(x0c, xkc, w)  # noqa: E731
    # a checkout whose K4 has no split constant is read alone
    split = "constexpr int kSplit" in (cuda_build.CSRC / "cin_interact_fwd.cu").read_text()
    builds = {"shipped": {}}
    if split:
        procs = {k: build_split({"kSplit": k}) for k in K4_SPLITS}
        builds.update({f"kSplit {k}": load_split(p) for k, p in procs.items()})
    times = {name: [] for name in builds}
    for name in list(builds) + list(builds)[::-1]:
        with use_build(builds[name]):
            times[name].append(cuda_time_ms(k4))
    emit(reading="timing", geometry=[h0, hk, o, bd], k4_ms=times,
         k5_ms=cuda_time_ms(lambda: cin_interact.cin_interact_bwd(x0c, xkc, w, cot)))


def main(argv):
    if not torch.cuda.is_available():
        print("chain_readings: no CUDA GPU available", file=sys.stderr)
        return 1
    from recman_tpu_torch.ops import cuda_build

    for name, log in cuda_build.build().items():
        emit(reading="build", library=name, ptxas=_ptxas(log))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    emit(reading="card", card=card, source=cuda_build.CSRC.as_posix())
    device = torch.device("cuda")
    for what in argv or ["accuracy", "timing"]:
        {"accuracy": accuracy, "k1_accuracy": k1_accuracy, "smoke_edges": smoke_edges,
         "dw_accuracy": dw_accuracy, "timing": timing}[what](device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
