"""The port's tools (recman_tpu_torch/tools/) against the JAX package's:
the bench entry, the step profile, the ABAB harness and the two-process
demo, at small shapes on the CPU.

The bench entry's cost model equals the root ``bench.step_cost_model``
exactly, and its setup has the JAX bench model's param names and shapes
at full width (drawn on the meta device: no values). ``main`` and
``run_check`` each print one JSON line with every key. The demo's world
of 2 Gloo ranks runs its three modes once for the module (started when
the module starts); the one-rank run of the dedup mode (one data rank:
the plain Trainer's batches) is held to JAX's plain ``Trainer.fit`` on
the same problem within 1e-4 relative (the demo's own bound).
"""

from __future__ import annotations

import json
import pathlib
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

import bench as jax_bench
from recman_tpu.data import create_criteo_features as j_criteo_features
from recman_tpu.data import synthetic_criteo_arrays as j_synthetic
from recman_tpu.models import DeepFM as JDeepFM
from recman_tpu.models import XDeepFM as JXDeepFM
from recman_tpu.training import Trainer as JTrainer
from recman_tpu_torch.layers import cin
from recman_tpu_torch.ops import cin_chain, embedding
from recman_tpu_torch.tools import abab, bench, multiprocess_demo, profile_step
from tests.torch_threads import worker_threads  # noqa: F401  (autouse)

TINY_HP = {"embedding_size": 4, "cin_cross_layer_units": (8, 8), "cin_dropout": (1, 1, 1),
           "deep_hidden_units": (16,), "deep_dropout": (1.0, 1.0)}
TINY = dict(device="cpu", num_buckets=200, n_rows=512, hparams=TINY_HP)
DEMO_TOL = 1e-4
BENCH_KEYS = {"metric", "value", "unit", "ms_per_step", "wall_ms_per_step", "mfu", "hbm_util",
              "model_gflops_per_step", "model_hbm_gb_per_step", "launches_per_step", "card"}
CHECK_KEYS = {"metric", "steps", "max_loss_delta", "final_loss_shipped", "final_loss_reference",
              "final_rel_delta", "bound_abs", "bound_rel", "loss_trace_ok", "ml_logloss", "ml_auc",
              "ml_anchor_ok", "ok", "card"}


@pytest.fixture(scope="module", autouse=True)
def demo():
    with ThreadPoolExecutor(max_workers=1) as pool:
        yield pool.submit(multiprocess_demo.run, 2, device="cpu", timeout_s=150)


# -- the bench entry -----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    {"batch": 4096, "vocab": 1000},
    {"k": 10, "cin_units": (200, 200, 200)},
    {"n_cat": 39, "n_dense": 0, "dnn": (1024, 512, 256)},
])
def test_step_cost_model_is_the_reference_s(kw):
    assert bench.step_cost_model(**kw) == jax_bench.step_cost_model(**kw)


def test_the_bench_constants_are_the_reference_s():
    for name in ("BATCH_SIZE", "NUM_BUCKETS", "N_ROWS", "MEASURE_STEPS"):
        assert getattr(bench, name) == getattr(jax_bench, name), name


def test_bench_setup_has_the_reference_params_at_full_width():
    model, data, layout, optimizer = bench.build_bench_setup(device="cpu")
    got = {k: tuple(v.shape) for k, v in
           model.init_params(torch.Generator().manual_seed(0), device="meta").items()}
    jmodel = JXDeepFM(j_criteo_features(num_buckets=bench.NUM_BUCKETS), dict(bench.HPARAMS))
    want = {k: tuple(v.shape) for k, v in
            jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)).items()}
    assert got == want
    assert next(iter(data.values())).shape[0] == bench.N_ROWS
    assert type(optimizer).__name__ == "Adam" and optimizer.learning_rate == 1e-3


def _one_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_bench_main_prints_one_line_with_every_key(capsys):
    out = bench.main(steps=3, batch_size=64, **TINY)
    line = _one_line(capsys)
    assert BENCH_KEYS <= set(line) and line == out
    assert line["metric"] == "xdeepfm_criteo_train_examples_per_sec_per_chip"
    assert set(line["launches_per_step"]) == {"K1 save", "K2", "K3"}
    for k in ("value", "ms_per_step", "wall_ms_per_step", "mfu", "hbm_util"):
        assert np.isfinite(line[k]) and line[k] > 0, k
    # no card and no kernel on the CPU
    assert line["card"] is None and "busy_share" not in line


def test_run_check_prints_one_line_with_every_key(capsys):
    out = bench.run_check(check_steps=4, ml_anchor=False, batch_size=64, **TINY)
    line = _one_line(capsys)
    assert CHECK_KEYS <= set(line) and line == out
    assert line["ok"] and line["loss_trace_ok"] and line["ml_anchor_ok"] is None
    assert line["max_loss_delta"] <= bench.CHECK_BOUND_ABS == 6e-3
    assert bench.CHECK_BOUND_REL == 0.01


def test_the_entries_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.build_bench_setup(num_buckets=10, n_rows=16)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        multiprocess_demo.run(2)


# -- the step profile ----------------------------------------------------------


@pytest.mark.parametrize("name,category", [
    ("void cin_chain_fwd_kernel(ChainArgs)", "hand-written"),
    ("void cin_chain_bwd_cols<4>(ColsArgs)", "hand-written"),
    ("cin_chain_bwd_reduce(float const*, int, int, float*)", "hand-written"),
    ("void cin_bwd_dw<__nv_bfloat16>(DwArgs<__nv_bfloat16>)", "hand-written"),
    ("segment_sums_kernel(int const*, float const*, int, int, int, Scratch)", "hand-written"),
    ("segment_write_kernel(Output, Output, int, int, int, Scratch)", "hand-written"),
    ("map_clear_kernel(unsigned int*, long long)", "hand-written"),
    ("void cin_interact_fwd_kernel(FwdArgs)", "hand-written"),
    ("void cin_interact_bwd_cols<8>(ColsArgs)", "hand-written"),
    ("one_table_kernel(int const*, float const*, int, int, int, float*, Scratch)", "hand-written"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128x32_warpgroupsize1x1x1", "conv/dot"),
    ("nvjet_tst_128x64_64x8_2x1_v_bz_TNT", "conv/dot"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_32x3_nn_align4>", "conv/dot"),
    ("void at::native::indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, true>", "scatter"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8>", "scatter"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "allreduce"),
    ("gloo:all_reduce", "allreduce"),
    ("void at::native::indexSelectLargeIndex<float, long, unsigned int, 2, 2, -2>", "gather/take"),
    ("void cub::DeviceRadixSortOnesweepKernel<Policy, false, int, int>", "sort"),
    ("Memcpy HtoD (Pageable -> Device)", "copy/transpose"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>", "other"),
])
def test_categorize(name, category):
    assert profile_step.categorize(name) == category


def test_the_kernel_symbols_are_the_sources_globals():
    csrc = pathlib.Path(profile_step.__file__).resolve().parents[1] / "csrc"
    text = "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu*")))
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text))
    named = {s for syms in profile_step.KERNEL_SYMBOLS.values() for s in syms}
    assert named == defined
    assert set(profile_step.KERNEL_SYMBOLS) == {f"K{i}" for i in range(1, 8)}


def test_a_cpu_profile_sums_to_its_total(capsys):
    out = profile_step.run(steps=2, batch=64, top=5, **TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["time"] == "cpu self" and line["profiled_ms_per_step"] > 0
    assert sum(line["ms_per_step_by_category"].values()) == pytest.approx(
        line["profiled_ms_per_step"], rel=1e-9)
    assert sum(out["kernels"].values()) == pytest.approx(line["profiled_ms_per_step"], rel=1e-9)
    assert {"conv/dot", "gather/take"} <= set(line["ms_per_step_by_category"])


# -- the ABAB harness ----------------------------------------------------------


@pytest.mark.parametrize("name", ["base", "nochain", "chain", "pertable", "scatter", "u8", "b4096",
                                  "dp", "gspmd", "savefm", "nosavefm", "bf16m",
                                  "base+nochain+pertable+u4", "dp+pertable+nochain+u2"])
def test_every_modifier_parses(name):
    spec = abab.parse_variant(name)
    assert set(spec) >= {"stacked", "chain", "kernel", "mode", "save_fmaps", "unroll", "batch"}


@pytest.mark.parametrize("name", ["ctf512", "ctb1024", "tv256", "cc64", "base+tv2048"])
def test_tpu_tile_modifiers_are_refused(name):
    with pytest.raises(ValueError, match="Pallas tile width"):
        abab.parse_variant(name)


def test_unknown_modifiers_are_refused():
    for name in ("base+foo", "u0", "gspmd+u4"):
        with pytest.raises(ValueError):
            abab.parse_variant(name)


def test_windows_run_a_b_a_b():
    assert abab.window_order(["A", "B"], 2) == [(0, "A"), (0, "B"), (1, "A"), (1, "B")]


def _defaults():
    return (cin.CIN_CHAIN_MODE, cin_chain.CHAIN_SAVE_FMAPS, embedding._grad_kernel(),
            embedding._mode())


def test_flags_are_set_around_every_call_and_put_back():
    model, data, layout, _ = bench.build_bench_setup("cpu", 200, 512, TINY_HP)
    v = abab.Variant(abab.parse_variant("nochain+nosavefm+scatter"), (model, data, layout, 512),
                     1, 64, torch.device("cpu"))
    seen = []

    def spy(state, data, idx_mat, layout):
        seen.append((cin.CIN_CHAIN_MODE, cin_chain.CHAIN_SAVE_FMAPS, embedding._grad_kernel()))
        assert idx_mat.shape == (1, 64)
        return state, torch.zeros(1)

    v.step = spy
    for i in range(3):
        v.call(i)
        assert _defaults() == ("auto", True, "auto", "auto")
    assert seen == [("off", False, "scatter")] * 3


def test_a_base_scatter_run_leaves_the_defaults(capsys):
    out = abab.main("base,scatter", rounds=2, steps=2, batch=64, **TINY)
    assert _defaults() == ("auto", True, "auto", "auto")
    assert out["order"] == ["base", "scatter"]
    for name in ("base", "scatter"):
        ws = out["variants"][name]["windows"]
        assert [w["round"] for w in ws] == [0, 1]
        assert np.isfinite(out["variants"][name]["device_ms_per_step"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metric"] == "abab"


# -- the two-process demo -------------------------------------------------------


def test_world_batches_on_one_data_rank_are_the_trainer_s():
    from recman_tpu_torch.training import batch_indices

    got = multiprocess_demo.world_batches(1024, 1, 256, 2019)
    assert np.array_equal(got, batch_indices(1024, 256, shuffle_seed=2019))
    two = multiprocess_demo.world_batches(1024, 2, 256, 2019)
    assert two.shape == (5, 256) and (two[4] == -1).all()
    assert sorted(two[two >= 0].tolist()) == list(range(1024))
    assert (two[:4, :128] < 512).all() and (two[:4, 128:] >= 512).all()


def test_the_demo_s_three_modes_in_one_world(demo):
    summary = demo.result()
    assert summary["ok"], summary["failures"]
    assert set(summary["modes"]) == {"psum", "dedup", "preempt"}
    ranks = summary["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for mode, res in summary["modes"].items():
        key = "param_l2" if mode == "preempt" else "mean_loss"
        got = {r["modes"][mode][key] for r in ranks}
        assert len(got) == 1, (mode, got)
        assert all(r["modes"][mode]["batches_match"] for r in ranks)
        assert res["abs_delta"] < DEMO_TOL, (mode, res)
    caps = {r["modes"]["dedup"]["dedup_capacity"] for r in ranks}
    assert len(caps) == 1 and 0 < caps.pop() <= 256


def test_the_one_rank_run_is_jax_s_plain_fit(demo):
    fs = j_criteo_features(num_buckets=multiprocess_demo.BUCKETS)
    data = j_synthetic(multiprocess_demo.ROWS, num_buckets=multiprocess_demo.BUCKETS,
                       seed=multiprocess_demo.DATA_SEED)
    t = JTrainer(JDeepFM(fs, {"embedding_size": 4, "deep_hidden_units": (16,),
                              "deep_dropout": (1.0, 1.0)}),
                 {"learning_rate": multiprocess_demo.LEARNING_RATE, "optimizer": "adam"},
                 epoch=multiprocess_demo.EPOCHS, batch_size=multiprocess_demo.BATCH,
                 random_seed=multiprocess_demo.SEED)
    t.fit({k: v for k, v in data.items() if k != "y"}, data["y"], random_seed_for_mini_batch=False)
    want = float(t.last_mean_loss)
    got = demo.result()["modes"]["dedup"]["single_process_mean_loss"]
    assert abs(got - want) <= DEMO_TOL * abs(want), (got, want)
