#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (recman_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU and the CUDA
toolkit (no JAX needed):

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit) when it fails:

1. setup: the card (nvidia-smi name and power limit), torch/CUDA
   versions, TF32 off; build every kernel in recman_tpu_torch/csrc (one
   nvcc per source, started together).
2. kernels: each kernel against its plain PyTorch version on the card at
   the main paths' full-width shapes and at a small test geometry, then
   timed (CUDA events, warm-up, median) beside the plain version, the
   least time the card could take for the same work and, where one
   PyTorch call computes the same function, that call: K1 without and
   with saved fmaps (cin_chain_fwd.cu), K2 (cin_chain_bwd.cu) on the
   full-width forward's fmaps, K2's recompute form (the same source; bit-
   equal to the save form, at batch 8192 and at 65,536), K3 and K7
   (segment_matmul.cu; K7 beside index_add_ into a (T*V, k_eff) buffer)
   on the sorted ids of 8192 synthetic Criteo rows, K3 also on those of
   65,536 (the large-batch step) beside scatter_add_ there, each bit-equal
   on two calls and profiled by pass. K1 and K2 are timed
   beside the bare bf16 contractions they do (torch.matmul on prebuilt
   operands), K2 profiled by phase; the chain is held end to end to the
   twin and layer by layer to the twin run on K1's own fmaps, and K1's
   layer 0 is read against an exact f64 sum beside the twin.
3. the serving slice end to end: full-width xDeepFM (26 hashed fields x
   100,000 buckets, k=16, CIN (100, 100), DNN (400, 400)) with random
   params from a seed, Predictor(batch_size=8192).predict on 65,536
   synthetic Criteo rows. Checks that K1 launched once per batch, that
   the predictions are finite and in (0, 1), and that the first batch
   matches the port's own CPU run. Then times steady predict calls and
   one batch's forward, and profiles a few forwards (device time by
   kernel, the card's busy share).
4. the training slice end to end: the same model in stacked table
   storage with Adam(1e-3), make_train_step_stacked on batches of 8192
   shuffled rows. Step 1's gradient of every param and the loss trace of
   the first steps are held against the same steps on the CPU (the
   port's plain path); then 32 timed steps on the card must launch K1,
   K2 and K3 once each per step with finite losses; then a profile of 3
   steps.
5. the Trainer slice end to end: xDeepFM on MovieLens-100K at the
   example's configuration (k 8, CIN (100, 100, 100), DNN (32, 32),
   batch 128). (a) 8 ``fit_on_batch`` steps from one seed's params, every
   keep 1, under ``grad_kernel("segmat")``, on the card and on the CPU
   (the kernels' twins): the loss trace and the valid predictions after
   them. (b) The anchor, ``examples.xdeepfm_ml.main(frac=0.5, epoch=1)``
   on the card under "segmat" with numpy's global generator seeded 2019:
   TEST logloss and AUC inside ``bench.py:251``'s bands, and the launch
   counts (K6 six times, K1 with saved fmaps and K2 once, per train step;
   K1 once per eval batch). (c) One epoch's steps timed under "segmat" and
   under "scatter", in the order segmat, scatter, scatter, segmat, each
   with a 3-step profile.

The kernels phase also holds K6 (segment_matmul.cu's row-major form, on
K3's sums in one launch) against its twin and, bit for bit, against K7 at
T = 1 at ML-100K's genres geometry, at one Criteo table and at the
sequence family's history (128 x 10 ids into item_id's 1,574 rows), with
its host cost beside index_add_'s and its profile,
and K4 (cin_interact_fwd.cu) and K5 (cin_interact_bwd.cu), one CIN
layer's forward and backward, against their twins at the xDeepFM paper's
Criteo layers (B 4096, D 10; layer 0, layers 1-2 and a final layer of
257 maps) and at a small geometry with a tail tile; K4 and K5 must be
bit-equal on two calls.

6. the per-layer CIN path at ``xdeepfm_paper_criteo``, the xDeepFM paper's
   Criteo setting (arXiv:1803.05170 section 4.1.3): k 10, CIN (200, 200,
   200), DNN (400, 400), Adam 0.001, batch 4096, L2 1e-4, on 26 hashed
   fields x 100,000 buckets. D = 10 is no chain geometry, so every CIN
   layer runs K4 forward and K5 backward. (a) Parity: one 4096-row
   predict batch and, at batch 1024, step 1's gradients and a 2-step
   ``fit_on_batch`` trace, card against CPU. (b) Serving: K4 three times
   a batch, K1 never; timed with a profile. (c) Training: ``Trainer.fit``
   one epoch over 65,536 rows, then ``evaluate``; K4 and K5 three times a
   step, K1 and K2 never; 16 steps timed with a profile. (d) ``cin_remat``:
   the same step-1 gradients, K4 six times a step, peak memory. (e) Live
   in-chain dropout: the per-layer path, finite losses. (f) The example
   ``examples.criteo_xdeepfm.main(embedding_size=10)``.

7. the large-batch slice: the reference's criteo_large_batch model (the
   bench model) with the warmup-plus-cosine schedule. (a) Parity at batch
   4096, card against CPU: step 1's gradients with saved fmaps and
   recomputed (and the two forms bit-equal on the card), and a 4-step
   ``fit_on_batch`` trace with ``large_batch_schedule`` and lamb. (b)
   ``examples.criteo_large_batch.main(batch_size=65536)`` on 2,000,000
   rows: VALID logloss finite, AUC > 0.5, K1 save, K2 and K3 once a step.
   (b, c) 8 steps timed with saved fmaps and with K2's recompute form
   (``CHAIN_SAVE_FMAPS = False``: K1 without fmaps and K2 recompute once a
   step, the save forms never), in the order save, recompute, recompute,
   save, each with its peak memory, which must be lower recomputed; the
   step's gradients bit-equal in both forms; 3-step profiles. (d)
   ``examples.criteo_xdeepfm.main(large_batch=True)`` on 1,000,000 rows.
8. the split lookup at the bench configuration, per-table step at batch
   8192 under ``split_lookup("on")``: step 1 with ``SEGMAT_VK_OUT`` on (K7
   once) and off (K3 once), gradients within 1e-5 of max|ref|; card
   against CPU on the same batch, with the DNN's and the CIN's activation
   derivatives read on the other side of 0 counted and bounded, and every
   gradient held with them read on the card's side; then 3 steps each of
   concat, split with K3 and split with
   K7, in the order concat, K3, K7, K7, K3, concat, each profiled once.
9. resilience and streaming, the bench model with Adam 1e-3 under the
   Trainer. (a) A resilient ``Trainer.fit`` of 2 epochs on 53,248 rows (7
   steps an epoch) preempted by a real SIGTERM at step 9 (checkpoints
   every 4 steps, 2 kept; LATEST must read step 9) and resumed by a fresh
   Trainer: every param, optimizer-state tensor, the step and the
   generator bit-equal (``torch.equal``) to the uninterrupted run; the
   resumed run launches K1 save, K2 and K3 once a step, K1 once an eval
   batch, and never reaches ``index_add_``. (b)
   ``Predictor.from_checkpoint`` on the final checkpoint: bit-equal to
   ``trainer.predict`` on 65,536 rows on the card, within ``PRED_TOL`` on
   the CPU over 2 batches; the card's checkpoint restored on the CPU
   (params, moments, step bit-equal; ``Trainer.restore`` there refuses
   the card's generator). (c) A Criteo-format TSV of 131,072 rows parsed
   by the native loader in full and in chunks of 32,768 (equal), then
   ``fit_stream(epochs=2)`` preempted at step 33 (epoch 2, chunk 2) and
   resumed, bit-equal to the uninterrupted ``fit_stream``, and
   ``predict_stream`` bit-equal to ``predict``. It prints the
   checkpoint's bytes, the save and restore seconds and the parse rate
   beside the card's name and power limit.
10. the zoo outside the sequence family: FM, DeepFM, DCN, FwFM,
   Wide&Deep, NFM, AFM, GDCN, DCN-V2 (full rank and rank 4), FinalMLP,
   FiBiNET, PNN, MaskNet, DLRM and AutoInt. (a) Each
   through ``examples.model_zoo_ml.run_model`` on MovieLens-100K (frac
   0.5, 1 epoch, Adam 1e-3, batch 128, the reference's seed-2019 params,
   numpy's global generator seeded 2019) under ``grad_kernel("segmat")``: TEST logloss within 0.02 and AUC
   within 0.015 of the run's ``docs/model_zoo.md`` row; K6 once per
   embedded field a step (from the schema and the lookup the model's
   forward calls: ``lookup_spy``, ``lookup_launches``), no other kernel,
   never ``index_add_``; the epoch and its median step by CUDA events.
   (c) GDCN's trainer saved with ``Trainer.save`` and served by
   ``Predictor.from_checkpoint`` on the card: its ``ua.test`` predictions
   equal to the trainer's ``predict``. (b)
   ``dcn_paper_criteo``, the DCN paper's Criteo setting (arXiv:1708.05123
   section 4.3) on the bench's hashed fields: k 107, DNN (1024, 1024)
   relu, 6 cross layers, batch 512, Adam 1e-3. ``Predictor.predict`` on
   65,536 rows, its first batch within 1e-5 of the CPU's; step 1's
   gradients in stacked storage against the CPU with the DNN's relu read
   on the card's side of 0, and a 4-step trace; 32 timed stacked steps
   with K3 once a step, a profile and the peak memory; a 1-epoch
   ``Trainer.fit`` on 180,000 rows (K3 once a step), VALID logloss
   finite and AUC over 0.5.
11. ``dlrm_mlperf_criteo``: DLRM at the widths of MLPerf Training's DLRM
   reference (embedding 128, bottom MLP 13-512-256-128, top MLP
   1024-1024-512-256-1 over 128 + 351 inputs, relu, no L2, SGD at lr 0.1)
   on the bench's hashed fields, about 335 M params. ``Predictor.predict``
   on 65,536 rows at 8192, its first batch within 1e-5 of the CPU's; at
   batch 2048 in per-table storage, step 1's gradients against the CPU
   with the bottom and top MLPs' relus read on the card's side of 0, a
   4-step trace, and K3 once a step at (T, C, N) = (26, 128, 2048) under
   "auto" (K6, K7, ``index_add_`` never); 32 timed steps with a profile and
   the peak memory; a 1-epoch ``Trainer.fit`` on 180,000 rows. The kernels
   phase holds K3 at that shape against its twin and times it beside
   ``scatter_add_`` and its bound.
12. the behaviour-sequence family: DIN, BST and DIEN at their defaults (k
   8, history max_len 10; DIN's attention (80, 40) and DNN (80, 40) with
   Dice, BST 1 block of 2 heads and FF 32, DIEN GRU 8 and DNN (80, 40)
   with Dice). (a) Each through ``run_model`` on MovieLens-100K as in 10
   (a), with the history feature, under ``grad_kernel("segmat")``: TEST
   logloss within 0.02 and AUC within 0.015 of its ``docs/model_zoo.md``
   row; K6 seven times a step (the history looks up item_id's table a
   second time), no other kernel, never ``index_add_``; the epoch and its
   median step by CUDA events, a 3-step profile. (b) Card against CPU
   from the seed-2019 params on the first batch of 128: step-1 gradients
   (BST's leaky_relu read on the card's side of 0, its flips counted), a
   4-step trace, ``Trainer.calibrate`` on 8,192 rows and the predictions
   of 2,048 valid rows after it. (c) DIN's calibrated params served by
   ``Predictor`` on ``ua.test`` at batch 128 and 1,024: within 1e-6 of
   each other, and the predict rate. (d) ``examples.din_synthetic.main``
   for din (3 epochs), bst and dien (15) under "segmat": VALID logloss
   and AUC within the zoo's bands of the JAX example's CPU readings
   (``SYNTH_ROWS``), K6 twice a step.
13. serving artifacts (runs right after the serving phase):
   ``Predictor.export`` and ``ExportedPredictor``. (a) The bench xDeepFM
   exported at batch 8192 as f32, load-time int8 and runtime int8
   (``tools/bench_serving.py``), each serving 65,536 rows: the f32
   artifact within 1e-6 of the live ``Predictor``, its graph holding K1 as
   the op node ``recman_tpu_torch::cin_chain_fwd``, K1 once per served
   batch and the plain twins never reached; runtime int8 within 1e-2 of
   f32 and 1e-6 of load-time int8, at 4k/(k+4) fewer table bytes on the
   card; examples/s, blob and table bytes printed. (b)
   ``xdeepfm_paper_criteo`` exported and serving 16,384 rows: within 1e-6
   of the live ``Predictor``, K4 three times a batch as the op node
   ``recman_tpu_torch::cin_interact_fwd``. (c) QR embeddings on all 26
   hashed fields (q 317: Q (316, 16), R (317, 16)) at the bench widths,
   batch 8192 under "segmat": step-1 gradients on the card's signs and a
   4-step trace against the CPU, K6 78 times a step (Q, R and the linear
   weights of each field, counted by (V, C)), never ``index_add_``; 8
   timed steps with a profile; then the trained model exported as
   runtime int8 (Q and R int8) and serving 65,536 rows within 1e-2 of the
   live ``Predictor``. (d) ``examples.xdeepfm_synthetic.main``: every
   Outdoor row falls after the override. The kernels phase holds K6 at
   the QR quotient shape (N 8192, V 316, C 16) against its twin and times
   it beside ``index_add_`` and its bound.

14. the parallel layer (runs right after resilience): the bench model
   through ``parallel.ShardedTrainer`` from the reference's seed-2019
   params (``utils.JaxKey``). (a) One rank on NCCL (a one-rank group that
   ``make_mesh`` starts), the explicit DP route: a 4-step trace within
   1e-6 of the plain ``Trainer``'s on the same index rows, K1 save, K2
   and K3 once a step. Then a spawned world of two Gloo ranks on this
   card (``parallel.launch.run_world``; NCCL refuses two ranks on one
   card): (b) explicit DP at (2, 1), 4,096 rows a rank: the trace within
   rtol 1e-3, atol 1e-4 of (a)'s, step-1 gradients within 1e-5 of
   max|ref| on (a)'s activation signs, K1 save, K2 and K3 once a step on
   each rank, ``predict`` equal to a plain ``Predictor`` within 1e-6; (c)
   the row-sharded route at (1, 2), the 26 tables and ``linear_w`` split
   over the two ranks, with the psum and then the dedup exchange (its
   capacity sized on the first batch): traces within (b)'s bounds of
   (a)'s, no dedup overflow, the dense params bit-equal across the ranks,
   K1 save and K2 once a step and no K3, K6 or K7, and each exchange's
   counted table bytes of a step equal to ``collective_traffic_model``'s;
   (d) the DNN tensor-parallel at (1, 2) (``tp_dense_threshold``
   100,000: layer 0 column-sharded, layer 1 row-sharded), its blocks'
   shapes, the trace within (b)'s bounds of (a)'s, K1 save and K2 once a
   step, the replicated params bit-equal across the ranks; (e) a
   resilient ``fit`` at (1, 2) preempted by a real SIGTERM to rank 1
   alone: both ranks checkpoint at the same step, and fresh trainers
   resume to an uninterrupted run's params, optimizer state, step and
   generator bit for bit; (f) ``fit_stream`` at (1, 2) against the plain
   Trainer's on the same chunks, K1 save, K2 and K3 once a step, and
   ``predict_stream`` equal to ``predict``; (g) DIEN with its auxiliary
   loss (weight 0.5) and Dice at (2, 1) on the sequence phase's ML-100K
   rows, against the plain Trainer: the step-1 gradients within 1e-5 of
   max|ref| (and, as a control, beyond it with Dice's moments taken on
   each rank's rows), the trace and ``calibrate``'s moments; (h) QR (q
   317) on the 26 hashed fields with Lamb at (1, 2) under "segmat", the
   export phase's QR route, the quotient tables row-sharded, against the
   plain Trainer: the trace, K6 53 times a step and no ``index_add_``.
   16 steps of (b)-(d) are timed. Two ranks share one card: no time is a
   scaling figure.

15. the port's tools (runs right after the training slice). (a)
   ``tools.bench.main()`` at full width: its one JSON line parsed, every
   number finite, K1 with saved fmaps, K2 and K3 once a step, the card
   named; its examples/s beside the training slice's "train steady". (b)
   ``tools.bench.run_check(ml_anchor=False)``: the shipped path against
   the per-table f32 path over 32 steps within 6e-3 and 1% final
   relative, K1 save, K2 and K3 once a step on the shipped path and never
   on the plain one. (c) ``tools.profile_step.run`` over 3 steps: K1's,
   K2's and K3's kernels under hand-written, the categories summing to the
   profiled total within 1%. (d) ``tools.abab.main("base,scatter")``, 2
   rounds of 16 steps: K3 once a step in base and never in scatter, the
   flags back at their shipped values. (e) ``tools.multiprocess_demo``'s
   three modes with 2 Gloo ranks on the card under
   ``grad_kernel("segmat")``: every check of the demo, and each rank's
   launches.

16. ``xdeepfm_wide_cin_criteo`` (runs right after the training slice):
   the bench model with its CIN set to (256, 256, 256), every fan-in 128.
   (a) ``Predictor.predict`` of 65,536 rows at batch 8192: K1 once a
   batch, never K4, the first 1,024 rows within 1e-5 of the CPU's. (b) 8
   stacked Adam steps at batch 1,024 against the CPU: step 1's gradients
   within 1e-3 of max|ref| on the card's activation signs and the loss
   trace within 6e-3 and 1% final relative, K1 save, K2 and K3 once a
   step, K4 and K5 never; two steps at 8192 under ``CHAIN_SAVE_FMAPS =
   False`` (K1 without fmaps and K2's recompute form once a step), the
   params bit-equal to the save form's. (c) 8 steps at 8192 timed on the
   chain and under ``CIN_CHAIN_MODE = "off"`` (K4 and K5 three times a
   step) in the order chain, off, off, chain, with busy shares and peak
   memory. The kernels phase holds K1 and K2 (both forms each) against
   their twins at the edges of the chain's range (``CHAIN_EDGES``: a final
   layer of 257 and of 512 maps, H0 128 with O 256, D 256, nine layers,
   and this model's tower at batch 8192), K1 end to end against the
   exact (f64) chain where two f32 sum orders part by more than K1_TOL,
   and times them beside their bounds and the bare contractions.

It prints a ``kernels`` JSON line (K1 save's, K2's, K3's and K6's records
carry ``parallel_launches``; K1's and K2's ``range_edges`` and
``wide_cin_launches``), the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

N_ROWS = 65_536
BATCH = 8192
NUM_BUCKETS = 100_000
HPARAMS = {
    "embedding_size": 16,
    "cin_cross_layer_units": (100, 100),
    "cin_dropout": (1, 1, 1),
    "deep_hidden_units": (400, 400),
    "deep_dropout": (1.0, 1.0, 1.0),
}
# K1 at the serving path's full-width shapes (H0, units, B, D), then at a
# small geometry of the tests
CHAIN_GEOMETRIES = {"full": (26, (100, 100), BATCH, 16), "small": (5, (6, 4), 64, 4)}
# the chain at the large-batch slice's batch (H0, units, B, D)
LARGE_GEOMETRY = (26, (100, 100), 65_536, 16)
# K1 and K2 at the edges of the reference chain's range (H0, units, B, D):
# a final layer of 257 maps (two passes of 256), the widest fields and
# maps, a final layer of 512, D 256 (two 128-column tiles a batch row),
# nine layers, and xdeepfm_wide_cin_criteo's tower at its batch
CHAIN_EDGES = {"final 257": (26, (100, 257), BATCH, 16), "fields 128": (128, (256, 256), BATCH, 8),
               "final 512": (26, (256, 512), 2048, 16), "D 256": (26, (100, 100), 256, 256),
               "9 layers": (26, (100,) * 9, 1024, 16), "wide": (26, (256, 256, 256), BATCH, 16)}
# Edges where two f32 sum orders part by more than K1_TOL end to end (the
# twin itself reads up to 1.054e-3 at D 256, 2.122e-3 at nine layers and
# 1.032e-3 at the wide tower from the exact chain): there K1 is held end
# to end to the exact (f64) chain instead, at these limits of max|exact|,
# just above K1's own readings at seeds 7 and 8 (up to 5.95e-4, 1.009e-3
# and 1.094e-3; recman_tpu_torch/tools/chain_readings.py smoke_edges,
# NVIDIA H100 80GB HBM3, 700 W). Layer by layer, on K1's own feed rows,
# K1 is held to its twin at K1_TOL everywhere.
K1_EXACT_TOL = {"D 256": 1e-3, "9 layers": 1.5e-3, "wide": 1.5e-3}
# xdeepfm_wide_cin_criteo: the bench model with its CIN set to (256, 256,
# 256), every fan-in 128, the widest maps the reference's field-major path
# takes (a stress geometry of the chain's range, not a published setting)
WIDE_HP = dict(HPARAMS, cin_cross_layer_units=(256, 256, 256), cin_dropout=(1, 1, 1, 1))
WIDE_STEPS = 8          # stacked steps held to the CPU, and timed in each route
WIDE_PARITY_BATCH = 1024  # rows a batch of the steps held to the CPU: bounds the CPU's time
WIDE_PRED_TOL = 1e-5    # predictions, card against CPU: f32 sums in another order
K1_TOL = 1e-3    # of max|ref|: same bf16 rounding both sides, f32 sum order differs
K2_TOL = 1e-3    # of max|ref|: gpre rounds to bf16 after f32 sums in another order
K3_TOL = 1e-5    # of max|ref|: f32 sums of up to 8192 terms in another order
PRED_TOL = 1e-4  # max |dp| between the GPU and the CPU run of the same batch
GRAD_TOL = 1e-3  # of max|ref| per param: step 1's gradient, GPU against CPU (K2's rounding)
# a piecewise-linear activation's derivative read on the other side of 0 by
# two runs of the same formulas (card and CPU, or a kernel and its twin):
# at most this share of the elements (or one), each where the reference
# lies within FLIP_ABS of its max|ref| of 0 (K1 and its twin on the card)
# or within the two runs' tolerance (card against CPU)
FLIP_SHARE = 1e-5
FLIP_ABS = 1e-5
DNN_Z_TOL = 1e-5  # of max|ref|: the DNN's f32 pre-activations, GPU against CPU
# of max|ref|: the CIN's fmaps, GPU against CPU. A layer past the first
# reads the one below's fmap rounded to bf16 after f32 sums whose order
# differs between the card and the CPU's matmul, so an element of it can
# land one bf16 step (up to 2**-7 of it) apart
FEED_TOL = 2.0 ** -7
TRACE_ABS, TRACE_REL = 6e-3, 0.01  # loss trace, GPU against CPU (bench.py:215's bounds)
CPU_STEPS = 4     # steps compared with the CPU
TIMED_STEPS = 32  # steps timed on the card
K6_TOL = 1e-5     # of max|ref|: f32 sums of the same rows in another order
# the Trainer slice (ML-100K at the example's configuration)
ML_SEED = 2019
ML_LR = 0.01          # the first of the example's lr grid
PARITY_STEPS = 8
# valid predictions after PARITY_STEPS steps, GPU against CPU: the two run
# the same formulas, summed in other orders. Adam's first steps move a
# param by about lr whatever its gradient's size, so a gradient near 0
# can move it the other way. Measured on the CPU between the JAX Pallas
# kernels interpreted and the port's twins (same formulas, other orders):
# 4.8e-4 after these 8 steps; the bound is 10x that.
PARITY_PRED_ABS = 5e-3
ANCHOR_LOGLOSS = (0.575, 0.615)  # bench.py:251
ANCHOR_AUC = (0.718, 0.748)
# K4 and K5 at the paper's Criteo layers (H0, Hk, O, B*D), at the final
# layer of 257 maps that the per-layer route sends them, and at a small
# geometry with a tail tile (B*D neither a multiple of 128 nor of 4)
INTERACT_GEOMETRIES = {"paper layer 0": (26, 26, 200, 4096 * 10),
                       "paper layers 1-2": (26, 100, 200, 4096 * 10),
                       "final layer 257": (26, 100, 257, 4096 * 10),
                       "small tail": (7, 5, 9, 301)}
INTERACT_RECORD = "paper layers 1-2"  # the geometry of the kernels line
K4_TOL = 1e-3  # of max|ref|: same bf16 roundings of z and W, f32 sum order differs
K5_TOL = 1e-3  # of max|ref| per output: the same, with g rounded to bf16
# xdeepfm_paper_criteo: the xDeepFM paper's Criteo setting (section 4.1.3)
PAPER_HP = {
    "learning_rate": 0.001,
    "optimizer": "adam",
    "embedding_size": 10,
    "cin_cross_layer_units": (200, 200, 200),
    "cin_dropout": (1, 1, 1, 1),
    "cin_activation": "leaky_relu",
    "deep_hidden_units": (400, 400),
    "deep_dropout": (1.0, 1.0, 1.0),
    "deep_l2_reg": 1e-4,
    "cin_l2_reg": 1e-4,
}
PAPER_BATCH = 4096
PAPER_ROWS = 65_536
PAPER_VALID = 8192  # rows for evaluate after the fit
PARITY_BATCH = 1024  # bounds the CPU's time for the parity steps
# the export phase: an artifact against the live Predictor on the same rows
# (the same kernels and roundings; only the batches' padding rows differ)
EXPORT_TOL = 1e-6
INT8_TOL = 1e-2            # runtime int8 against f32 (tools/bench_serving.py's bound)
PAPER_SERVE_ROWS = 16_384  # xdeepfm_paper_criteo's exported serving
QR_COLLISIONS = 317        # ceil(sqrt(100,001)): Q (316, k) and R (317, k) per hashed field
QR_STEPS = 8               # timed QR train steps
# the large-batch slice: the reference's criteo_large_batch configuration
# (the bench model; Adam, or lamb, with large_batch_schedule)
LARGE_HP = dict(HPARAMS, optimizer="adam")
LARGE_BATCH = 65_536
LARGE_ROWS = 2_000_000   # the example's default rows, split 95/5
PARITY_LARGE = 4096      # the parity steps' batch (the CPU runs them too)
TIMED_LARGE = 8          # steps timed in each form
RECIPE_ROWS = 1_000_000  # rows of the Criteo example's large-batch recipe
# the resilience phase: the bench model with Adam 1e-3 under Trainer.fit
# and fit_stream
RESUME_HP = dict(HPARAMS, optimizer="adam", learning_rate=1e-3)
RESUME_ROWS = 6 * BATCH + BATCH // 2  # 53,248 rows: 7 steps an epoch
PREEMPT_STEP = 9                      # mid-epoch 2
STREAM_ROWS = 131_072                 # rows of the phase's TSV
STREAM_CHUNK = 32_768                 # 4 chunks of 5 steps an epoch
STREAM_PREEMPT_STEP = 33              # epoch 2, chunk 2, its 3rd batch
# the zoo phase: (a) the sixteen runs of the ML-100K quality protocol
# (docs/model_zoo.md:9-12, tools/zoo_quality.py) outside the sequence
# family, each held to a band around its row there (JAX on the CPU: TEST
# logloss, AUC) of the xDeepFM anchor's widths (bench.py:251: 0.575-0.615,
# 0.718-0.748 around 0.594 / 0.733). A label that is not a model's name
# runs ZOO_RUNS' model and hparams.
ZOO_ROWS = {"fm": (0.6275, 0.6920), "deepfm": (0.6265, 0.6970), "dcn": (0.6217, 0.7007),
            "fwfm": (0.6221, 0.7029), "wide_deep": (0.6315, 0.6902), "nfm": (0.6508, 0.6690),
            "afm": (0.6614, 0.6577), "gdcn": (0.6014, 0.7244), "dcn_v2": (0.6022, 0.7226),
            "dcn_v2_rank4": (0.6047, 0.7239), "final_mlp": (0.6064, 0.7215),
            "fibinet": (0.6103, 0.7123), "pnn": (0.6135, 0.7068), "masknet": (0.6148, 0.7081),
            "dlrm": (0.6170, 0.7077), "autoint": (0.6334, 0.6859)}
ZOO_RUNS = {"dcn_v2_rank4": ("dcn_v2", {"cross_rank": 4})}
ZOO_LOGLOSS_BAND, ZOO_AUC_BAND = 0.02, 0.015
ZOO_CHECKPOINT = "gdcn"  # (c) the run saved and served from its checkpoint
# (b) dcn_paper_criteo: the DCN paper's Criteo setting (arXiv:1708.05123
# section 4.3: 2 deep layers of 1024, 6 cross layers, batch 512, Adam;
# embedding size 6 * cardinality ** 0.25 = 107 for the 100,001-row hashed
# tables) on the bench's 26 x 100,000-bucket hashed fields and 13 dense
DCN_HP = {"learning_rate": 1e-3, "optimizer": "adam", "embedding_size": 107,
          "deep_hidden_units": (1024, 1024), "deep_dropout": (1.0, 1.0, 1.0),
          "deep_activation": "relu", "cross_layer_num": 6}
DCN_BATCH = 512
DCN_SERVE_ROWS = 65_536
DCN_SERVE_BATCH = 8192
DCN_FIT_ROWS = 200_000  # the Criteo example's rows, split 90/10
DCN_PRED_TOL = 1e-5     # card against CPU: f32 sums in another order, TF32 off
# dlrm_mlperf_criteo: DLRM at the widths of MLPerf Training's DLRM reference
# (mlcommons/training recommendation; facebookresearch/dlrm
# bench/run_and_time.sh): embedding 128, bottom MLP 13-512-256-128, top MLP
# 1024-1024-512-256-1 over the bottom output and the 351 pairs of 27 fields,
# relu, no L2, plain SGD at lr 0.1 (the DLRM repository's Criteo scripts),
# on the bench's 26 x 100,000-bucket hashed fields and 13 dense; batch 2048
DLRM_HP = {"learning_rate": 0.1, "optimizer": "sgd", "embedding_size": 128,
           "embedding_l2_reg": 0.0, "bot_hidden_units": (512, 256), "bot_activation": "relu",
           "bot_l2_reg": 0.0, "top_hidden_units": (1024, 1024, 512, 256),
           "top_dropout": (1.0,) * 5, "top_activation": "relu", "top_l2_reg": 0.0}
DLRM_BATCH = 2048
DLRM_SERVE_ROWS = 65_536
DLRM_SERVE_BATCH = 8192
DLRM_FIT_ROWS = 200_000  # split 90/10, as dcn_paper_criteo's
DLRM_PRED_TOL = 1e-5     # card against CPU, TF32 off
# the sequence phase: (a) DIN, BST and DIEN through run_model at their
# hparam defaults, held to the docs/model_zoo.md rows with the zoo's bands
# phase_parallel: parallel/ at the bench model's widths
PARALLEL_HP = dict(HPARAMS, optimizer="adam", learning_rate=1e-3)
PARALLEL_STEPS = 4        # checked steps of every run
PARALLEL_TIMED = 16       # timed steps of every run
PARALLEL_ONE_RANK_TOL = 1e-6  # (a): loss trace relative to the plain Trainer's
PARALLEL_TRACE_RTOL, PARALLEL_TRACE_ATOL = 1e-3, 1e-4  # (b), (c) against (a)
PARALLEL_GRAD_TOL = 1e-5  # of max|ref|: (b)'s step-1 gradients on (a)'s activation signs
PARALLEL_PRED_TOL = 1e-6  # (b): predict against a plain Predictor on the same params
PARALLEL_WORLD_S = 400    # the two-rank world's deadline
PARALLEL_TP = 100_000     # (d) tp_dense_threshold: the DNN's (429, 400) and (400, 400) layers shard
PARALLEL_STREAM_CHUNK = 16_384  # (f) rows a chunk: 3 steps each (the last one all padding)
PARALLEL_STREAM_CHUNKS = 3
PARALLEL_RESUME_EPOCHS = 2      # (e) RESUME_ROWS' 7 steps an epoch, preempted at PREEMPT_STEP
PARALLEL_DIEN_HP = {"aux_loss_weight": 0.5, "learning_rate": 1e-3, "optimizer": "adam"}
PARALLEL_QR_HP = dict(HPARAMS, optimizer="lamb", learning_rate=1e-3)
PARALLEL_QR_THRESHOLD = 256     # (h) below the quotient tables' 316 rows, so that they shard
PARALLEL_QR_K6 = 53             # (h) K6 a step: 26 quotient blocks, 26 remainders, linear_w's exchange
# the tools' phase
TOOLS_ABAB = "base,scatter"
TOOLS_ABAB_ROUNDS = 2
TOOLS_ABAB_STEPS = 16
TOOLS_PROFILE_STEPS = 3
TOOLS_PROFILE_SUM = 0.01  # the categories' sum against the profiled total, relative

SEQ_ROWS = {"din": (0.6077, 0.7149), "bst": (0.6104, 0.7097), "dien": (0.6045, 0.7209)}
SEQ_BATCH = 128
SEQ_PRED_TOL = 1e-5    # (b) predictions after calibrate, card against CPU
SEQ_MOMENT_TOL = 1e-5  # of max|ref|: the moments calibrate writes, card against CPU
SEQ_SERVE_TOL = 1e-6   # (c) the same rows served at batch 128 and at 1,024
# (d) examples.din_synthetic.main: (epochs, VALID logloss, AUC) of the JAX
# package's own example on the CPU, each held to the zoo's bands. Read with
# numpy's global generator seeded 2019 before each run:
#   JAX_PLATFORMS=cpu python -c "import numpy as np; np.random.seed(2019);
#   from recman_tpu.examples.din_synthetic import main; print(main(epoch=3,
#   model_name='din')[1])"   (epoch 15 for bst and dien)
SYNTH_ROWS = {"din": (3, 0.5060006467483583, 0.8664864458962229),
              "bst": (15, 0.5379909579748231, 0.8724437435858927),
              "dien": (15, 0.4248114416757104, 0.8875622637731221)}


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup=3, reps=25):
    """Median device time of one fn() call over reps back-to-back calls.

    A CUDA event is recorded between consecutive calls and the host
    synchronises only at the end, so the host enqueues ahead of the card
    and each interval is the call's device time, not the host's overhead.
    """
    import torch

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


def host_time_ms(fn, warmup=3, reps=200):
    """Mean host time of one fn() call: the host clock around reps
    back-to-back calls, before the synchronise that ends them (what a call
    costs the host where the card keeps up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def chain_inputs(h0, units, b, d, seed, device):
    import torch

    g = torch.Generator().manual_seed(seed)
    x0c = torch.randn((h0, b * d), generator=g)
    ws, bs, hk = [], [], h0
    for o in units:
        ws.append(torch.randn((h0 * hk, o), generator=g) * (2.0 / (h0 * hk + o)) ** 0.5)
        bs.append(0.1 * torch.randn((o,), generator=g))
        hk = o // 2
    return x0c.to(device), [w.to(device) for w in ws], [v.to(device) for v in bs]


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """Least time (ms) for work of ``flops`` operations and ``nbytes`` moved
    (each input read once, each output written once), and which bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def chain_bound_ms(x0c, ws, bs, outs):
    """Least time for K1's work (``outs``: the pooled blocks, and the fmaps
    when saving): bf16 products over the tensor-core peak, or the bytes."""
    bd = x0c.shape[1]
    flops = sum(2 * bd * w.shape[0] * w.shape[1] for w in ws)
    moved = nbytes(x0c, *ws, *bs, *outs)
    return (*bound(flops, moved), flops, moved)


def chain_bwd_bound_ms(x0c, ws, gs, fmaps, grads):
    """Least time for K2's work: dW and u each a bf16 product of the size
    of the forward's; bytes: x0c, W, the pooled cotangents and the fmaps
    in, dx0, dW and db out."""
    bd = x0c.shape[1]
    flops = sum(2 * 2 * bd * w.shape[0] * w.shape[1] for w in ws)
    moved = nbytes(x0c, *ws, *gs, *fmaps, grads[0], *grads[1], *grads[2])
    return (*bound(flops, moved), flops, moved)


def chain_bwd_recompute_bound_ms(x0c, ws, bs, gs, grads):
    """Least time for K2's recompute form: the forward's bf16 products
    (K1's) and the backward's (dW and u), or x0c, W, b and the pooled
    cotangents in and dx0, dW and db out."""
    bd = x0c.shape[1]
    flops = sum(3 * 2 * bd * w.shape[0] * w.shape[1] for w in ws)
    moved = nbytes(x0c, *ws, *bs, *gs, grads[0], *grads[1], *grads[2])
    return (*bound(flops, moved), flops, moved)


def chain_library_ms(x0c, ws, fmaps, units, parts, reps=10):
    """The bare bf16 contractions of the chain's kernels, one PyTorch call
    each on prebuilt operands: per layer torch.matmul(W^T, z) for K1
    ("fwd"), torch.matmul(W, gpre) and torch.matmul(z, gpre^T) for K2
    ("bwd"), timed together. z is built from x0c and the fmaps beforehand;
    gpre stands in as bf16 of the layer's fmap, of gpre's shape (a dense
    product's time does not depend on its values). No PyTorch call builds
    z or gpre, so this is the contraction alone."""
    import torch

    h0 = x0c.shape[0]
    x0b = x0c.to(torch.bfloat16)
    ops, hk = [], h0
    for i, (w, o) in enumerate(zip(ws, units)):
        xk = x0c if i == 0 else fmaps[i - 1][:hk]
        z = (x0b[:, None, :] * xk.to(torch.bfloat16)[None, :, :]).reshape(h0 * hk, -1)
        ops.append((w.to(torch.bfloat16), z, fmaps[i].to(torch.bfloat16)))
        hk = o // 2

    def run():
        for wb, z, gp in ops:
            if "fwd" in parts:
                torch.matmul(wb.t(), z)
            if "bwd" in parts:
                torch.matmul(wb, gp)
                torch.matmul(z, gp.t())

    ms = cuda_time_ms(run, reps=reps)
    del ops
    return ms


def k1_layer0_error(x0c, ws, bs, act, got, twin):
    """Mean and max |fmap_0 - exact| over max|exact| for K1 and for its
    twin, the exact sum in f64 (z and W are bf16 values, so every product
    is exact). Logs them; K1's feed rows round to bf16, so its error against
    the exact sum sets how often a feed element lands on the other side of
    a rounding from the twin's."""
    import torch

    from recman_tpu_torch.ops import cin_chain

    h0 = x0c.shape[0]
    x0b = x0c.to(torch.bfloat16)
    z0 = (x0b[:, None, :] * x0b[None, :, :]).reshape(h0 * h0, -1).double()
    exact = cin_chain._act(act, ws[0].to(torch.bfloat16).double().t() @ z0
                           + bs[0].double()[:, None])
    del z0
    scale = exact.abs().max().item()
    errs = [((f.double() - exact).abs().mean().item() / scale,
             (f.double() - exact).abs().max().item() / scale) for f in (got, twin)]
    feed = exact.shape[0] // 2
    ex_b = exact[:feed].float().to(torch.bfloat16)
    other = [int((f[:feed].to(torch.bfloat16) != ex_b).sum()) for f in (got, twin)]
    log(f"K1 layer 0 against the exact f64 sum: mean|d|/max {errs[0][0]:.3e}, max {errs[0][1]:.3e} "
        f"(twin: {errs[1][0]:.3e}, {errs[1][1]:.3e}); feed elements whose bf16 rounding differs "
        f"from the exact sum's: {other[0]} (twin {other[1]}) of {ex_b.numel()}")


def sign_flips(refs, gots, tol, what, near_tol=FLIP_ABS):
    """``gots`` against ``refs`` (pre-activations, or fmaps after a
    piecewise-linear activation) to tol of max|ref|, and the elements of
    other sign: at most FLIP_SHARE of them (or one), each where the
    reference lies within near_tol of max|ref| of 0. Logs the readings per
    tensor before it checks them; returns the count of such elements."""
    stats = []
    for i, (r, g) in enumerate(zip(refs, gots)):
        check(g.shape == r.shape, f"{what}[{i}] shape {tuple(g.shape)} vs {tuple(r.shape)}")
        scale = r.abs().max().item() or 1.0
        flip = (r > 0) != (g > 0)
        n_flip = int(flip.sum())
        near = r[flip].abs().max().item() / scale if n_flip else 0.0
        stats.append(((g - r).abs().max().item() / scale, n_flip, near, r.numel()))
    log(f"{what}, per tensor: max|d|/max|ref|, elements of other sign, the largest |ref| "
        f"among them over max|ref|: " + "; ".join(
            f"{e:.3e}, {n} of {m}, {near:.3e}" for e, n, near, m in stats))
    for i, (e, n_flip, near, _) in enumerate(stats):
        check(e <= tol, f"{what}[{i}]: max|d|/max|ref| {e} > {tol}")
        check(near <= near_tol, f"{what}[{i}]: a sign differs where |ref|/max|ref| is {near}")
    flips, numel = sum(s[1] for s in stats), sum(s[3] for s in stats)
    check(flips <= max(1, FLIP_SHARE * numel),
          f"{what}: {flips} of {numel} elements differ in sign")
    return flips


def k1_twins(x0c, ws, bs, units, d, act, got, what, e2e_tol=K1_TOL):
    """K1's twin on K1's own input, layer by layer: layer i+1 of the twin
    takes the feed rows of K1's fmaps[i] (``cin_chain_fm_reference``'s
    ``feeds``). Returns its pooled blocks and fmaps, to which K1 is held at
    K1_TOL. First K1's save-form outputs ``got`` (pooled blocks, then
    fmaps) are held to the twin run end to end, at ``e2e_tol`` (None:
    logged only, where the caller holds K1 to the exact chain); the count
    of feed elements that the two round to neighbouring bf16 values (sums
    in another order straddling a rounding, which the next layers carry)
    is logged."""
    import torch

    from recman_tpu_torch.ops import cin_chain

    n = len(units)
    e2e = cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True)
    apart = sum(int((f[: o // 2].to(torch.bfloat16) != t[: o // 2].to(torch.bfloat16)).sum())
                for f, t, o in zip(got[n:-1], e2e[n:-1], units[:-1]))
    rels = [(r - g).abs().max().item() / (r.abs().max().item() or 1.0) for r, g in zip(e2e, got)]
    log(f"{what}: K1 against the twin end to end, max|d|/max|ref| per pooled block "
        f"{[f'{e:.3e}' for e in rels[:n]]}, per fmap {[f'{e:.3e}' for e in rels[n:]]}; feed "
        f"elements rounded to another bf16 value than the twin's: {apart} of "
        f"{sum(o // 2 for o in units[:-1]) * x0c.shape[1]}")
    if e2e_tol is not None:
        max_rel_err(e2e, got, e2e_tol, f"{what}: K1 against the twin end to end")
    del e2e
    return cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act, save=True,
                                            feeds=got[n:])


def check_recompute(x0c, ws, bs, gs, units, d, act, k1_out, got, what, e2e_tol=K1_TOL):
    """K2's recompute form against K2's twin on K1's fmaps (the last
    len(units) of K1's save-form outputs ``k1_out``: the bits the kernel
    rebuilds) to K2_TOL of max|ref|. Those fmaps are first held to K1's
    twin on K1's own input to K1_TOL and end to end to ``e2e_tol``
    (``k1_twins``; None: logged only), with their sign differences bounded by ``sign_flips``. The twin's own fmaps
    are not K2's input: they can round a feed element to the neighbouring
    bf16 value, and at an element of other sign read the activation's
    derivative on the other side of 0, which moves that column's gpre by
    0.8 of a term. Returns (max|d|, sign differences)."""
    import torch

    from recman_tpu_torch.ops import cin_chain

    n = len(units)
    fmaps = k1_out[n:]
    twin = k1_twins(x0c, ws, bs, units, d, act, k1_out, what, e2e_tol)[n:]
    flips = sign_flips(twin, fmaps, K1_TOL, f"{what}: K1's fmaps")
    del twin
    ref = cin_chain.cin_chain_bwd_reference(x0c, ws, bs, gs, fmaps, units, d, act)
    err = max_rel_err([ref[0], *ref[1], *ref[2]], [got[0], *got[1], *got[2]], K2_TOL, what)
    torch.cuda.synchronize()
    return err, flips


def time_k2_recompute(x0c, ws, bs, gs, units, d, act, err, label, fmaps):
    """K2's recompute form timed beside its twin, its bound and the bare
    contractions it does (K1's and K2's, ``chain_library_ms`` on K1's
    ``fmaps``), then profiled by kernel."""
    from recman_tpu_torch.ops import cin_chain

    got = cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act)
    ms = cuda_time_ms(lambda: cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act),
                      reps=10)
    plain_ms = cuda_time_ms(lambda: cin_chain.cin_chain_bwd_recompute_reference(
        x0c, ws, bs, gs, units, d, act), warmup=1, reps=5)
    lib_ms = chain_library_ms(x0c, ws, fmaps, units, ("fwd", "bwd"))
    bnd, by, flops, moved = chain_bwd_recompute_bound_ms(x0c, ws, bs, gs, got)
    log(f"K2 recompute {label} (B*D={x0c.shape[1]}): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (the three bf16 matmuls a layer alone) {lib_ms:.4f} ms, "
        f"bound {bnd:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB), "
        f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    profile_device(lambda: cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act), ms,
                   f"K2 recompute calls {label} (its phases by kernel)", n=3)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms}


def k2_recompute_large_batch(device):
    """K2's recompute form at the large-batch geometry (B 65,536), its main
    path's: against its twin, bit-equal to the save form on K1's saved
    fmaps, then timed beside both forms. Returns its record."""
    import torch

    from recman_tpu_torch.ops import cin_chain

    h0, units, b, d = LARGE_GEOMETRY
    n = len(units)
    x0c, ws, bs = chain_inputs(h0, units, b, d, seed=8, device=device)
    out = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, "leaky_relu", save=True)
    g = torch.Generator().manual_seed(14)
    gs = [torch.randn(p.shape, generator=g).to(device) for p in out[:n]]
    saved = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[n:], units, d, "leaky_relu")
    got = cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, "leaky_relu")
    torch.cuda.synchronize()
    check(all(torch.equal(a, c) for a, c in zip([saved[0], *saved[1], *saved[2]],
                                                [got[0], *got[1], *got[2]])),
          "K2 recompute at B 65,536: not bit-equal to K2 save")
    err, flips = check_recompute(x0c, ws, bs, gs, units, d, "leaky_relu", out, got,
                                 "K2 recompute at B 65,536")
    rec = time_k2_recompute(x0c, ws, bs, gs, units, d, "leaky_relu", err, f"B {b}", out[n:])
    k1s_ms = cuda_time_ms(lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, "leaky_relu",
                                                          save=True), reps=10)
    k2_ms = cuda_time_ms(lambda: cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[n:], units, d,
                                                         "leaky_relu"), reps=10)
    lib_fwd = chain_library_ms(x0c, ws, out[n:], units, ("fwd",))
    lib_bwd = chain_library_ms(x0c, ws, out[n:], units, ("bwd",))
    f1 = sum(2 * x0c.shape[1] * w.shape[0] * w.shape[1] for w in ws)
    log(f"K2 recompute at B {b}: max|d| {err:.3e} against its plain version ({flips} fmap "
        f"elements of other sign than the twin's), bit-equal to K2 save; {rec['ms']:.4f} ms "
        f"against K1 save {k1s_ms:.4f} ms + K2 save {k2_ms:.4f} ms")
    log(f"at B {b}: K1 save {k1s_ms:.4f} ms ({f1 / k1s_ms / 1e9:.1f} TFLOP/s), library (bf16 "
        f"matmul W^T z a layer) {lib_fwd:.4f} ms; K2 save {k2_ms:.4f} ms "
        f"({2 * f1 / k2_ms / 1e9:.1f} TFLOP/s), library (W gpre and z gpre^T a layer) "
        f"{lib_bwd:.4f} ms")
    profile_device(lambda: cin_chain.cin_chain_bwd(x0c, ws, bs, gs, out[n:], units, d,
                                                   "leaky_relu"), k2_ms,
                   f"K2 save calls at B {b} (its phases by kernel)", n=3)
    return rec


def segmat_bound_ms(sids, sg, out):
    """Least time for K3's work: one f32 add per cotangent element (CUDA
    cores), or the ids and cotangents in and the dense grads out."""
    flops = sg.numel()
    moved = nbytes(sids, sg, out)
    return (*bound(flops, moved, PEAK_F32_FLOPS), flops, moved)


def criteo_ids(rows):
    """The sorted ids (26, rows) of synthetic Criteo rows: K3's, K6's and
    K7's input on the main paths."""
    from recman_tpu_torch.data import CAT_NAMES, synthetic_criteo_arrays

    data = synthetic_criteo_arrays(rows, num_buckets=NUM_BUCKETS, seed=2019)
    return np.sort(np.stack([data[c] for c in CAT_NAMES]).astype(np.int32), axis=1)


def max_rel_err(refs, gots, tol, what):
    """max |ref - got| over the pairs, each checked against tol * max|ref|."""
    worst = 0.0
    for i, (r, g) in enumerate(zip(refs, gots)):
        check(g.shape == r.shape, f"{what}[{i}] shape {tuple(g.shape)} vs {tuple(r.shape)}")
        err = (r - g).abs().max().item()
        scale = r.abs().max().item()
        check(err <= tol * scale, f"{what}[{i}]: max|d| {err} > {tol} * {scale}")
        worst = max(worst, err)
    return worst


def chain_edge(device, label, h0, units, b, d):
    """K1 (both forms) and K2 (both forms) at an edge of the reference
    chain's range, held to their twins as at full width (K1 end to end,
    or to the exact chain at K1_EXACT_TOL's edges, and layer by layer on
    its own feed rows, K2 on K1's fmaps, the recompute
    form bit-equal to the save form and held to its twin), then each
    timed beside its twin, its bound and the bare contractions it does.
    Returns {kernel: record}."""
    import torch

    from recman_tpu_torch.ops import cin_chain
    from recman_tpu_torch.tools import chain_readings

    act, n = "leaky_relu", len(units)
    what = f"[{label} H0={h0} units={units} B={b} D={d}]"
    x0c, ws, bs = chain_inputs(h0, units, b, d, seed=7, device=device)
    got = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act)
    got_s = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, c) for a, c in zip(got, got_s[:n])),
          f"K1 {what}: the two forms' pooled blocks differ")
    e2e_tol = None if label in K1_EXACT_TOL else K1_TOL
    if e2e_tol is None:
        pooled, fmaps = chain_readings.exact_chain(x0c, ws, bs, units, d, act)
        exact = [*pooled, *fmaps]
        del pooled, fmaps
        gaps = chain_readings.rel(exact, got_s)
        log(f"K1 save {what} against the exact (f64) chain end to end: max|d|/max|exact| per "
            f"pooled block {[f'{e:.3e}' for e in gaps[:n]]}, per fmap "
            f"{[f'{e:.3e}' for e in gaps[n:]]}")
        max_rel_err(exact, got_s, K1_EXACT_TOL[label],
                    f"K1 save {what}: against the exact chain end to end")
        del exact
    ref = k1_twins(x0c, ws, bs, units, d, act, got_s, f"K1 save {what}", e2e_tol)
    e1 = max_rel_err(ref[:n], got, K1_TOL, f"K1 {what}")
    e1s = max_rel_err(ref, got_s, K1_TOL, f"K1 save {what}")
    g = torch.Generator().manual_seed(11)
    gs = [torch.randn(p.shape, generator=g).to(device) for p in ref[:n]]
    del ref
    fm = got_s[n:]
    got_b = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, fm, units, d, act)
    ref_b = cin_chain.cin_chain_bwd_reference(x0c, ws, bs, gs, fm, units, d, act)
    e2 = max_rel_err([ref_b[0], *ref_b[1], *ref_b[2]], [got_b[0], *got_b[1], *got_b[2]], K2_TOL,
                     f"K2 {what}")
    del ref_b
    got_r = cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act)
    torch.cuda.synchronize()
    check(all(torch.equal(a, c) for a, c in zip([got_b[0], *got_b[1], *got_b[2]],
                                                [got_r[0], *got_r[1], *got_r[2]])),
          f"K2 recompute {what}: not bit-equal to K2 save")
    e2r, flips = check_recompute(x0c, ws, bs, gs, units, d, act, got_s, got_r,
                                 f"K2 recompute {what}", e2e_tol)
    lib_fwd = chain_library_ms(x0c, ws, fm, units, ("fwd",))
    lib_bwd = chain_library_ms(x0c, ws, fm, units, ("bwd",))
    runs = {
        "K1": (lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act),
               lambda: cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act),
               chain_bound_ms(x0c, ws, bs, got), lib_fwd, e1),
        "K1 save": (lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True),
                    lambda: cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act,
                                                             save=True),
                    chain_bound_ms(x0c, ws, bs, got_s), lib_fwd, e1s),
        "K2": (lambda: cin_chain.cin_chain_bwd(x0c, ws, bs, gs, fm, units, d, act),
               lambda: cin_chain.cin_chain_bwd_reference(x0c, ws, bs, gs, fm, units, d, act),
               chain_bwd_bound_ms(x0c, ws, gs, fm, got_b), lib_bwd, e2),
        "K2 recompute": (lambda: cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act),
                         lambda: cin_chain.cin_chain_bwd_recompute_reference(
                             x0c, ws, bs, gs, units, d, act),
                         chain_bwd_recompute_bound_ms(x0c, ws, bs, gs, got_r),
                         chain_library_ms(x0c, ws, fm, units, ("fwd", "bwd")), e2r),
    }
    out = {}
    for name, (fn, plain, (bnd, by, flops, moved), lib_ms, err) in runs.items():
        ms = cuda_time_ms(fn, reps=10)
        plain_ms = cuda_time_ms(plain, warmup=1, reps=3)
        out[name] = {"geometry": [h0, list(units), b, d], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}
        log(f"{name} {what}: max|d| {err:.3e} against its plain version, {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library (the bare bf16 matmuls) {lib_ms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB), "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
    log(f"K2 recompute {what}: bit-equal to K2 save, {flips} fmap elements of other sign than "
        f"the twin's")
    return out


def phase_kernels(device):
    """Every kernel against its plain version at the small and the full
    geometry, then timed at full width. Returns the kernels' records."""
    import torch

    from recman_tpu_torch.ops import cin_chain, segment_matmul

    rec = {}
    for label, (h0, units, b, d) in CHAIN_GEOMETRIES.items():
        n = len(units)
        x0c, ws, bs = chain_inputs(h0, units, b, d, seed=7, device=device)
        for act in ("leaky_relu", "relu", "identity") if label == "small" else ("leaky_relu",):
            got = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act)
            got_s = cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True)
            torch.cuda.synchronize()
            ref = k1_twins(x0c, ws, bs, units, d, act, got_s, f"K1 save {label} {act}")
            e1 = max_rel_err(ref[:n], got, K1_TOL, f"K1 {label} {act}")
            e1s = max_rel_err(ref, got_s, K1_TOL, f"K1 save {label} {act}")
            g = torch.Generator().manual_seed(11)
            gs = [torch.randn(p.shape, generator=g).to(device) for p in ref[:n]]
            got_b = cin_chain.cin_chain_bwd(x0c, ws, bs, gs, got_s[n:], units, d, act)
            torch.cuda.synchronize()
            ref_b = cin_chain.cin_chain_bwd_reference(x0c, ws, bs, gs, got_s[n:], units, d, act)
            e2 = max_rel_err([ref_b[0], *ref_b[1], *ref_b[2]],
                             [got_b[0], *got_b[1], *got_b[2]], K2_TOL, f"K2 {label} {act}")
            # K2's recompute form: the save form's bits, and its twin
            got_r = cin_chain.cin_chain_bwd_recompute(x0c, ws, bs, gs, units, d, act)
            torch.cuda.synchronize()
            check(all(torch.equal(a, c) for a, c in zip([got_b[0], *got_b[1], *got_b[2]],
                                                        [got_r[0], *got_r[1], *got_r[2]])),
                  f"K2 recompute {label} {act}: not bit-equal to K2 save")
            e2r, flips = check_recompute(x0c, ws, bs, gs, units, d, act, got_s, got_r,
                                         f"K2 recompute {label} {act}")
            log(f"K1/K1 save/K2/K2 recompute vs plain [{label} H0={h0} units={units} B={b} D={d} "
                f"{act}]: max|d| {e1:.3e} / {e1s:.3e} / {e2:.3e} / {e2r:.3e} ({flips} fmap "
                f"elements of other sign than the twin's), K2 recompute bit-equal to K2 save; "
                f"max|ref| pooled "
                f"{max(r.abs().max().item() for r in ref[:n]):.4g}, dx0 "
                f"{ref_b[0].abs().max().item():.4g}, dW {[round(w.abs().max().item(), 4) for w in ref_b[1]]}")
        if label != "full":
            continue
        act = "leaky_relu"
        k1_layer0_error(x0c, ws, bs, act, got_s[n], ref[n])
        lib_fwd = chain_library_ms(x0c, ws, got_s[n:], units, ("fwd",))
        lib_bwd = chain_library_ms(x0c, ws, got_s[n:], units, ("bwd",))
        ms = cuda_time_ms(lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act))
        plain_ms = cuda_time_ms(
            lambda: cin_chain.cin_chain_fm_reference(x0c, ws, bs, units, d, act), reps=20)
        bnd, by, flops, moved = chain_bound_ms(x0c, ws, bs, got)
        rec["K1"] = {"max_abs_err": e1, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by, "library_ms": lib_fwd}
        log(f"K1 full width: {ms:.4f} ms, plain {plain_ms:.4f} ms, library (bf16 matmul W^T z "
            f"a layer, on a prebuilt z) {lib_fwd:.4f} ms, bound {bnd:.4f} ms "
            f"({by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB), "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
        ms = cuda_time_ms(lambda: cin_chain.cin_chain_fwd(x0c, ws, bs, units, d, act, save=True))
        plain_ms = cuda_time_ms(lambda: cin_chain.cin_chain_fm_reference(
            x0c, ws, bs, units, d, act, save=True), reps=20)
        bnd, by, flops, moved = chain_bound_ms(x0c, ws, bs, got_s)
        rec["K1 save"] = {"max_abs_err": e1s, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                          "bound_by": by, "library_ms": lib_fwd}
        log(f"K1 save full width: {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_fwd:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB), "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
        fm = got_s[n:]
        ms = cuda_time_ms(lambda: cin_chain.cin_chain_bwd(x0c, ws, bs, gs, fm, units, d, act))
        plain_ms = cuda_time_ms(lambda: cin_chain.cin_chain_bwd_reference(
            x0c, ws, bs, gs, fm, units, d, act), reps=20)
        bnd, by, flops, moved = chain_bwd_bound_ms(x0c, ws, gs, fm, got_b)
        rec["K2"] = {"max_abs_err": e2, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                     "bound_by": by, "library_ms": lib_bwd}
        log(f"K2 full width: {ms:.4f} ms, plain {plain_ms:.4f} ms, library (bf16 matmuls W gpre "
            f"and z gpre^T a layer, on prebuilt operands) {lib_bwd:.4f} ms, bound {bnd:.4f} ms "
            f"({by}; {flops / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB), "
            f"{flops / ms / 1e9:.1f} TFLOP/s achieved")
        profile_device(lambda: cin_chain.cin_chain_bwd(x0c, ws, bs, gs, fm, units, d, act), ms,
                       "K2 save calls at full width (its phases by kernel)", n=3)
        time_k2_recompute(x0c, ws, bs, gs, units, d, act, e2r, "full width", fm)
    rec["K2 recompute"] = k2_recompute_large_batch(device)
    for label, geometry in CHAIN_EDGES.items():
        t0 = time.perf_counter()
        for name, r in chain_edge(device, label, *geometry).items():
            rec[name].setdefault("range_edges", {})[label] = r
        torch.cuda.empty_cache()
        log(f"chain edge [{label}] {time.perf_counter() - t0:.1f} s")

    # K3: a small Zipf case, then the full-width sorted ids of one batch
    # and of one large-batch step (timed at both)
    rs = np.random.RandomState(3)
    small_ids = np.sort(np.minimum(rs.zipf(1.2, size=(3, 70)) + 1, 49).astype(np.int32), axis=1)
    full_ids = criteo_ids(BATCH)
    vocab_full = NUM_BUCKETS + 1
    c_bench = HPARAMS["embedding_size"] + 1
    # and dlrm_mlperf_criteo's grouped lookup: one batch's ids at C 128
    for label, ids, v, c in (("small", small_ids, 50, 5), ("full", full_ids, vocab_full, c_bench),
                             ("large batch", criteo_ids(LARGE_BATCH), vocab_full, c_bench),
                             ("C 128", criteo_ids(DLRM_BATCH), vocab_full,
                              DLRM_HP["embedding_size"])):
        t, nn = ids.shape
        sids = torch.from_numpy(ids).to(device)
        sg = torch.randn((t, c, nn), generator=torch.Generator().manual_seed(12)).to(device)
        got = segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v)
        again = segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v)
        torch.cuda.synchronize()
        ref = segment_matmul.segment_matmul_reference(sids, sg, v)
        e3 = max_rel_err([ref], [got], K3_TOL, f"K3 {label}")
        rel3 = e3 / ref.abs().max().item()
        check(torch.equal(got == 0, ref == 0), f"K3 {label}: zeros differ from the plain version")
        check(torch.equal(got, again), f"K3 {label}: two calls differ")
        longest = max(int(torch.unique_consecutive(r, return_counts=True)[1].max()) for r in sids)
        log(f"K3 vs plain [{label} T={t} C={c} N={nn} V={v}]: max|d| {e3:.3e}, "
            f"max|ref| {ref.abs().max().item():.4g}, empty columns exact, two calls "
            f"bit-equal; longest run of one id {longest} of {nn}")
        if label == "small":
            continue
        ms = cuda_time_ms(lambda: segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v))
        plain_ms = cuda_time_ms(lambda: segment_matmul.segment_matmul_reference(sids, sg, v),
                                reps=20 if label == "full" else 5)
        idx = sids.long()[:, None, :].expand(t, c, nn)
        lib_ms = cuda_time_ms(lambda: torch.zeros((t, c, v), device=device).scatter_add_(2, idx, sg))
        bnd, by, flops, moved = segmat_bound_ms(sids, sg, got)
        r = {"max_abs_err": e3, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
             "bound_by": by, "library_ms": lib_ms}
        log(f"K3 {label} (N={nn}): {ms:.4f} ms, plain {plain_ms:.4f} ms, library (scatter_add_) "
            f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}; {moved / 1e6:.2f} MB), "
            f"{moved / ms / 1e6:.1f} GB/s achieved")
        r["kernel_ms"] = profile_device(
            lambda: segment_matmul.segment_matmul_from_sorted_batched(sids, sg, v), ms,
            f"K3 calls [{label}] (its passes by kernel)", n=3)
        if label == "full":
            rec["K3"] = r
        elif label == "large batch":
            rec["K3"]["large_batch"] = dict(r, n=nn)
        else:
            rec["K3"]["dlrm_mlperf_criteo"] = dict(r, n=nn, c=c, max_rel_err=rel3)
        del got, again, ref

    # K7: the same ids, the cotangents split into k_emb table rows and one
    # vector row, row-major table grads
    for label, ids, v, (k_emb, n_vec) in (("small", small_ids, 50, (4, 1)),
                                          ("full", full_ids, vocab_full, (HPARAMS["embedding_size"], 1))):
        t, nn = ids.shape
        c = k_emb + n_vec
        sids = torch.from_numpy(ids).to(device)
        sg = torch.randn((t, c, nn), generator=torch.Generator().manual_seed(15)).to(device)
        got = segment_matmul.segment_matmul_from_sorted_batched_vk(sids, sg, v, k_emb, n_vec)
        again = segment_matmul.segment_matmul_from_sorted_batched_vk(sids, sg, v, k_emb, n_vec)
        torch.cuda.synchronize()
        ref = segment_matmul.segment_matmul_vk_reference(sids, sg, v, k_emb, n_vec)
        e7 = max_rel_err(list(ref), list(got), K3_TOL, f"K7 {label}")
        check(all(torch.equal(a == 0, r == 0) for a, r in zip(got, ref)),
              f"K7 {label}: zeros differ from the plain version")
        check(all(torch.equal(a, r) for a, r in zip(got, again)), f"K7 {label}: two calls differ")
        log(f"K7 vs plain [{label} T={t} k_emb={k_emb} n_vec={n_vec} N={nn} V={v}]: max|d| "
            f"{e7:.3e}, max|ref| {max(r.abs().max().item() for r in ref):.4g}, empty rows exact, "
            f"two calls bit-equal")
    ms = cuda_time_ms(lambda: segment_matmul.segment_matmul_from_sorted_batched_vk(
        sids, sg, v, k_emb, n_vec))
    plain_ms = cuda_time_ms(lambda: segment_matmul.segment_matmul_vk_reference(
        sids, sg, v, k_emb, n_vec), reps=20)
    # one PyTorch call for the same sums, row-major: index_add_ of the
    # (T*N, k_eff) cotangent rows into a (T*V, k_eff) buffer
    flat_ids = (sids.long() + v * torch.arange(t, device=device)[:, None]).reshape(-1)
    rows = sg.transpose(1, 2).reshape(t * nn, c).contiguous()
    lib_ms = cuda_time_ms(lambda: torch.zeros((t * v, c), device=device).index_add_(0, flat_ids, rows))
    bnd, by, flops, moved = segmat_bound_ms(sids, sg, got[0])
    moved += nbytes(got[1])
    bnd, by = bound(flops, moved, PEAK_F32_FLOPS)
    rec["K7"] = {"max_abs_err": e7, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
                 "bound_by": by, "library_ms": lib_ms}
    log(f"K7 full width: {ms:.4f} ms, plain {plain_ms:.4f} ms, library (index_add_ into "
        f"(T*V, k_eff)) {lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}; {moved / 1e6:.2f} MB), "
        f"{moved / ms / 1e6:.1f} GB/s achieved; K3 at the same shape {rec['K3']['ms']:.4f} ms")
    rec["K7"]["kernel_ms"] = profile_device(lambda: segment_matmul.segment_matmul_from_sorted_batched_vk(
        sids, sg, v, k_emb, n_vec), ms, "K7 calls [full] (its passes by kernel)", n=3)

    # K6: ML-100K's genres ids of the first train batch (the longest run
    # of the anchor's step), one Criteo table of the same 8192 rows, then
    # the sequence family's history ids of its first train batch
    genres = ml_genres_ids()
    history, item_v = ml_history_ids()
    qr_v = -(-vocab_full // QR_COLLISIONS)
    for label, ids, v, c in (("genres", genres, 20, 9),
                             ("criteo", full_ids[0], vocab_full, HPARAMS["embedding_size"] + 1),
                             ("history", history, item_v, 8),
                             ("qr", full_ids[0] // QR_COLLISIONS, qr_v,
                              HPARAMS["embedding_size"])):
        sids = torch.from_numpy(np.sort(ids).astype(np.int32)).to(device)
        sg = torch.randn((len(ids), c), generator=torch.Generator().manual_seed(13)).to(device)
        got = segment_matmul.segment_matmul_from_sorted(sids, sg, v)
        again = segment_matmul.segment_matmul_from_sorted(sids, sg, v)
        # K7's passes at T = 1 on the transposed cotangents: the same sums
        k7 = segment_matmul.segment_matmul_from_sorted_batched_vk(
            sids[None], sg.t().contiguous()[None], v, c, 0)[0][0]
        torch.cuda.synchronize()
        ref = segment_matmul.segment_matmul_rows_reference(sids, sg, v)
        e6 = max_rel_err([ref], [got], K6_TOL, f"K6 {label}")
        check(torch.equal(got == 0, ref == 0), f"K6 {label}: zeros differ from the plain version")
        check(torch.equal(got, again), f"K6 {label}: two calls differ")
        check(torch.equal(got, k7), f"K6 {label}: differs from K7 at T = 1")
        longest = int(torch.unique_consecutive(sids, return_counts=True)[1].max())
        ms = cuda_time_ms(lambda: segment_matmul.segment_matmul_from_sorted(sids, sg, v))
        plain_ms = cuda_time_ms(lambda: segment_matmul.segment_matmul_rows_reference(sids, sg, v),
                                reps=20)
        lib_ms = cuda_time_ms(lambda: torch.zeros((v, c), device=device).index_add_(0, sids, sg))
        # what a call costs the host: the anchor's step is host-bound
        host_ms = host_time_ms(lambda: segment_matmul.segment_matmul_from_sorted(sids, sg, v))
        lib_host_ms = host_time_ms(lambda: torch.zeros((v, c), device=device)
                                   .index_add_(0, sids, sg))
        bnd, by, flops, moved = segmat_bound_ms(sids, sg, got)
        log(f"K6 vs plain [{label} N={len(ids)} V={v} C={c}, longest run {longest}]: max|d| "
            f"{e6:.3e}, max|ref| {ref.abs().max().item():.4g}, empty rows exact, two calls "
            f"and K7 at T = 1 bit-equal; {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"(index_add_) {lib_ms:.4f} ms, bound {bnd:.6f} ms ({by}; {moved / 1e6:.3f} MB); "
            f"host {host_ms:.4f} ms a call, index_add_'s {lib_host_ms:.4f}")
        kernel_ms = profile_device(lambda: segment_matmul.segment_matmul_from_sorted(sids, sg, v),
                                   ms, f"K6 calls [{label}]", n=3)
        r = {"max_abs_err": e6, "ms": ms, "kernel_ms": kernel_ms, "host_ms": host_ms,
             "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms,
             "library_host_ms": lib_host_ms}
        if label == "genres":
            rec["K6"] = r
        else:
            rec["K6"][label] = dict(r, n=len(ids), v=v, c=c)
        del got, again, k7, ref
    return rec


def interact_bound_ms(x0c, xkc, w, outs, passes):
    """Least time for K4's (passes=1) or K5's (passes=2) work: ``passes``
    bf16 products of 2*X*O*B*D operations, or each input read and each
    output written once."""
    flops = passes * 2 * w.shape[0] * w.shape[1] * x0c.shape[1]
    moved = nbytes(x0c, xkc, w, *outs)
    return (*bound(flops, moved), flops, moved)


def phase_interact_kernels(device):
    """K4 and K5 against their twins at every geometry of
    INTERACT_GEOMETRIES, K4 and K5 bit-equal on two calls; then timed at
    the full-width geometries beside the twins, their bounds and the
    library's contraction alone. Returns the records of INTERACT_RECORD."""
    import torch

    from recman_tpu_torch.ops import cin_interact

    rec = {}
    for label, (h0, hk, o, bd) in INTERACT_GEOMETRIES.items():
        g = torch.Generator().manual_seed(17)
        x0c = torch.randn((h0, bd), generator=g).to(device)
        xkc = torch.randn((hk, bd), generator=g).to(device)
        w = (torch.randn((h0 * hk, o), generator=g) * (2.0 / (h0 * hk + o)) ** 0.5).to(device)
        cot = torch.randn((o, bd), generator=g).to(device)
        got = cin_interact.cin_interact_fwd(x0c, xkc, w)
        got_again = cin_interact.cin_interact_fwd(x0c, xkc, w)
        grads = cin_interact.cin_interact_bwd(x0c, xkc, w, cot)
        again = cin_interact.cin_interact_bwd(x0c, xkc, w, cot)
        torch.cuda.synchronize()
        ref = cin_interact.cin_interact_fm_reference(x0c, xkc, w)
        e4 = max_rel_err([ref], [got], K4_TOL, f"K4 {label}")
        ref_b = cin_interact.cin_interact_fm_bwd_reference(x0c, xkc, w, cot)
        e5 = max_rel_err(ref_b, grads, K5_TOL, f"K5 {label}")
        check(torch.equal(got, got_again), f"K4 {label}: two calls differ")
        check(all(torch.equal(a, b) for a, b in zip(grads, again)), f"K5 {label}: two calls differ")
        log(f"K4/K5 vs plain [{label} H0={h0} Hk={hk} O={o} B*D={bd}]: max|d| {e4:.3e} / "
            f"{e5:.3e}; max|ref| pre {ref.abs().max().item():.4g}, dx0 "
            f"{ref_b[0].abs().max().item():.4g}, dxk {ref_b[1].abs().max().item():.4g}, dW "
            f"{ref_b[2].abs().max().item():.4g}; K4 and K5 bit-equal on two calls")
        if label == "small tail":
            continue
        z = (x0c.to(torch.bfloat16)[:, None, :] * xkc.to(torch.bfloat16)[None, :, :]).reshape(
            h0 * hk, bd)
        w_bf, g_bf = w.to(torch.bfloat16), cot.to(torch.bfloat16)
        times = {}
        for what, fn in (
            ("K4", lambda: cin_interact.cin_interact_fwd(x0c, xkc, w)),
            ("K4 plain", lambda: cin_interact.cin_interact_fm_reference(x0c, xkc, w)),
            ("K4 library", lambda: torch.matmul(w_bf.t(), z)),
            ("K5", lambda: cin_interact.cin_interact_bwd(x0c, xkc, w, cot)),
            ("K5 plain", lambda: cin_interact.cin_interact_fm_bwd_reference(x0c, xkc, w, cot)),
            ("K5 library", lambda: (torch.matmul(w_bf, g_bf), torch.matmul(z, g_bf.t()))),
        ):
            times[what] = cuda_time_ms(fn, reps=10 if "plain" in what else 20)
        b4, by4, f4, m4 = interact_bound_ms(x0c, xkc, w, [got], 1)
        b5, by5, f5, m5 = interact_bound_ms(x0c, xkc, w, grads, 2)
        log(f"K4 [{label}]: {times['K4']:.4f} ms, plain {times['K4 plain']:.4f} ms, library "
            f"(bf16 matmul on a prebuilt z, the contraction alone) {times['K4 library']:.4f} ms, "
            f"bound {b4:.4f} ms ({by4}; {f4 / 1e9:.2f} GFLOP, {m4 / 1e6:.2f} MB), "
            f"{f4 / times['K4'] / 1e9:.1f} TFLOP/s achieved")
        log(f"K5 [{label}]: {times['K5']:.4f} ms, plain {times['K5 plain']:.4f} ms, library "
            f"(the two bf16 matmuls alone) {times['K5 library']:.4f} ms, bound {b5:.4f} ms "
            f"({by5}; {f5 / 1e9:.2f} GFLOP, {m5 / 1e6:.2f} MB), "
            f"{f5 / times['K5'] / 1e9:.1f} TFLOP/s achieved")
        if label != INTERACT_RECORD:
            continue
        rec["K4"] = {"max_abs_err": e4, "ms": times["K4"], "plain_ms": times["K4 plain"],
                     "bound_ms": b4, "bound_by": by4, "library_ms": times["K4 library"]}
        rec["K5"] = {"max_abs_err": e5, "ms": times["K5"], "plain_ms": times["K5 plain"],
                     "bound_ms": b5, "bound_by": by5, "library_ms": times["K5 library"]}
    return rec


def ml_genres_ids():
    """The genres ids of one batch of the anchor's train set (rows shuffled
    with seed 2019), PAD clamped to 0 as the packed layer does: N = 128 x
    19."""

    from recman_tpu_torch.data import concat_rows, create_ml_features, get_ml_dataset
    from recman_tpu_torch.training import batch_indices

    train, valid, _, domains = get_ml_dataset(frac=0.5, random_seed=ML_SEED)
    fs = create_ml_features(concat_rows(train, valid), domains)
    genres = fs["genres"].transform(train["genres"])["genres"]
    rows = batch_indices(len(genres), 128, shuffle_seed=ML_SEED)[0]
    return np.maximum(genres[rows], 0).reshape(-1)


def phase_serving(device):
    import torch

    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops import cin_chain
    from recman_tpu_torch.serving import Predictor

    t0 = time.perf_counter()
    model = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), HPARAMS)
    params = model.init_params(torch.Generator().manual_seed(0))  # default device: CUDA
    check(all(v.is_cuda for v in params.values()), "params not on the GPU")
    data = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    data.pop("y")
    predictor = Predictor(model, params, batch_size=BATCH)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in params.values())
    log(f"setup: {n_params} params ({4 * n_params / 1e6:.1f} MB f32), "
        f"{N_ROWS} rows, {time.perf_counter() - t0:.2f} s")

    n_batches = N_ROWS // BATCH + 1
    cin_chain.LAUNCHES = 0
    t0 = time.perf_counter()
    preds = predictor.predict(data)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cin_chain.LAUNCHES
    check(launches == n_batches, f"K1 launched {launches} times for {n_batches} batches")
    check(preds.shape == (N_ROWS,), f"predictions shape {preds.shape}")
    check(bool(np.isfinite(preds).all()), "non-finite predictions")
    check(bool(((preds > 0) & (preds < 1)).all()), "predictions outside (0, 1)")
    log(f"predict (first call): {first_s:.3f} s; K1 launches {launches} = batches {n_batches}; "
        f"preds mean {preds.mean():.6f} std {preds.std():.6f}")

    # the same params and first batch on the CPU
    params_cpu = {k: v.cpu() for k, v in params.items()}
    batch_cpu = {k: torch.as_tensor(v[:BATCH]) for k, v in data.items()}
    t0 = time.perf_counter()
    with torch.inference_mode():
        preds_cpu = model.apply(params_cpu, batch_cpu).numpy()
    cpu_s = time.perf_counter() - t0
    dp = float(np.abs(preds_cpu - preds[:BATCH]).max())
    check(dp <= PRED_TOL, f"GPU vs CPU first batch: max|dp| {dp} > {PRED_TOL}")
    log(f"GPU vs CPU, first batch of {BATCH}: max|dp| {dp:.3e} (CPU forward {cpu_s:.2f} s)")

    # steady state: whole predict calls (host encode-free arrays -> device,
    # 9 batches, results back) and the device time of one batch's forward
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        predictor.predict(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    dev = {k: torch.as_tensor(v[:BATCH]).cuda() for k, v in data.items()}
    override = torch.as_tensor(model.linear.override_vector()).cuda()

    def forward():
        with torch.inference_mode():
            return model.apply(predictor.params, dev, linear_override=override)

    batch_ms = cuda_time_ms(forward, reps=20)
    log(f"predict steady: {wall * 1e3:.3f} ms per call of {N_ROWS} rows "
        f"({wall * 1e3 / n_batches:.3f} ms per batch incl. padding batch), "
        f"{N_ROWS / wall:.1f} examples/s; one batch forward (device) {batch_ms:.4f} ms, "
        f"{BATCH / batch_ms * 1e3:.1f} examples/s")
    profile_device(forward, batch_ms, "batch forwards")
    return launches


def ml_seq_tables():
    """run_model's sequence tables: the splits with the history feature,
    the sequence schema, the encoded splits. Returns (tables, fs, x)."""
    from recman_tpu_torch.data import (
        add_history_feature, concat_rows, create_ml_sequence_features, get_ml_dataset,
    )

    train, valid, test, domains, index = get_ml_dataset(frac=0.5, random_seed=ML_SEED,
                                                        return_index=True)
    tables = add_history_feature(train, valid, test, index=index)
    fs = create_ml_sequence_features(concat_rows(*tables[:2]), domains)
    return tables, fs, [fs.transform(t) for t in tables]


def ml_history_ids():
    """The history ids of the sequence family's first train batch (rows
    shuffled with seed 2019), PAD clamped to 0 as the lookup does:
    N = 128 x 10 rows of item_id's table. Returns (ids, V)."""
    from recman_tpu_torch.training import batch_indices

    _, fs, (x_train, _, _) = ml_seq_tables()
    hist = x_train["hist_items"]
    rows = batch_indices(len(hist), SEQ_BATCH, shuffle_seed=ML_SEED)[0]
    return np.maximum(hist[rows], 0).reshape(-1), fs["item_id"].feat_size


def profile_device(fn, unit_ms, what, n=5):
    """Device time by kernel over n calls of fn, and the card's busy share:
    kernel time per call over the call's device time measured without the
    profiler (which slows the host and so idles the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernel_ms = sum(e.self_device_time_total for e in averages
                    if e.device_type == DeviceType.CUDA) / 1e3 / n
    log(f"profile of {n} {what}: kernels {kernel_ms:.4f} ms per call, busy share "
        f"{kernel_ms / unit_ms:.4f} of {unit_ms:.4f} ms" if kernel_ms else
        f"profile of {n} {what}: no device time traced (busy share not measured)")
    table = averages.table(sort_by="self_cuda_time_total", row_limit=16, max_name_column_width=60)
    log("\n".join(table.splitlines()[:20]))
    return kernel_ms or None


def phase_training(device):
    """The stacked train step at full width: GPU against the port's CPU
    run, then timed. Returns the launches of the timed run per kernel and
    the "train steady" reading (examples/s by device and by wall time)."""
    import torch

    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops import cin_chain, segment_matmul
    from recman_tpu_torch.serving import batch_indices
    from recman_tpu_torch.training import (
        TrainState, create_optimizer, gather_batch, make_train_step_stacked, pack_dataset,
        stack_table_params, unpack_batch,
    )
    from recman_tpu_torch.training.train_step import loss_and_grads

    t0 = time.perf_counter()
    model = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), HPARAMS)
    opt = create_optimizer("adam", 1e-3)
    params, names = stack_table_params(
        model, model.init_params(torch.Generator().manual_seed(0)))  # default device: CUDA
    check(all(v.is_cuda for v in params.values()), "params not on the GPU")
    packed, layout = pack_dataset(synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=2019))
    idx_np = batch_indices(N_ROWS, BATCH, shuffle_seed=0)
    idx_np = idx_np[(idx_np >= 0).all(axis=1)]  # drop the all-padding batch, as bench.py does
    data = {k: torch.as_tensor(v).to(device) for k, v in packed.items()}
    idx = torch.as_tensor(idx_np).to(device)
    torch.cuda.synchronize()
    log(f"training setup: stacked leaf {tuple(params['__stacked_feat_embed'].shape)}, "
        f"{len(idx_np)} batches of {BATCH}, {time.perf_counter() - t0:.2f} s")

    def first_grads(p, d, ix):
        batch, w = gather_batch(d, ix[0])
        return loss_and_grads(model, p, unpack_batch(batch, layout), w, names=names)

    def trace(p, d, ix):
        state = TrainState(p, opt.init(p), 0, None)
        state, losses = make_train_step_stacked(model, opt, CPU_STEPS, names)(state, d, ix, layout)
        return state, losses

    # the same first steps on the card and on the CPU, from the same params
    params_cpu = {k: v.cpu() for k, v in params.items()}
    data_cpu = {k: torch.as_tensor(v) for k, v in packed.items()}
    idx_cpu = torch.as_tensor(idx_np)
    loss_g, grads_g = first_grads(params, data, idx)
    _, trace_g = trace(params, data, idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_c, grads_c = first_grads(params_cpu, data_cpu, idx_cpu)
    _, trace_c = trace(params_cpu, data_cpu, idx_cpu)
    cpu_s = time.perf_counter() - t0
    rel, worst = grads_match(grads_c, grads_g, "step-1 grad, GPU vs CPU")
    leaf = (grads_g["__stacked_feat_embed"].cpu() - grads_c["__stacked_feat_embed"]).abs().max() \
        / grads_c["__stacked_feat_embed"].abs().max()
    tg, tc = trace_g.cpu().numpy(), trace_c.numpy()
    max_d, final_rel = trace_match(tg, tc, "loss trace")
    log(f"training GPU vs CPU (CPU {CPU_STEPS} steps + step-1 grads in {cpu_s:.1f} s): step-1 loss "
        f"{loss_g.item():.7f} vs {loss_c.item():.7f}; grads max|d|/max|ref| worst {rel:.3e} "
        f"({worst}), stacked leaf {leaf.item():.3e}; trace GPU {tg.tolist()} "
        f"CPU {tc.tolist()}: max|d| {max_d:.3e}, final rel {final_rel:.3e}")

    # timed: TIMED_STEPS single steps on the card, counts from 0
    step = make_train_step_stacked(model, opt, 1, names)
    state = TrainState(params, opt.init(params), 0, None)
    for i in range(3):  # warm-up
        state, _ = step(state, data, idx[i:i + 1], layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cin_chain.LAUNCHES = cin_chain.BWD_LAUNCHES = segment_matmul.LAUNCHES = 0
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TIMED_STEPS):
        j = i % len(idx_np)
        state, loss = step(state, data, idx[j:j + 1], layout)
        losses.append(loss)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": cin_chain.LAUNCHES, "K2": cin_chain.BWD_LAUNCHES, "K3": segment_matmul.LAUNCHES}
    for name, count in launches.items():
        check(count == TIMED_STEPS, f"{name} launched {count} times in {TIMED_STEPS} steps")
    losses = torch.cat(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), "non-finite loss in the timed steps")
    step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    steady = {"examples_per_s": BATCH / step_ms * 1e3, "wall_examples_per_s": TIMED_STEPS * BATCH / wall}
    log(f"train steady: {TIMED_STEPS} steps, launches {launches}; step (device, median) "
        f"{step_ms:.4f} ms, {BATCH / step_ms * 1e3:.1f} examples/s; wall {wall * 1e3 / TIMED_STEPS:.3f} "
        f"ms/step, {TIMED_STEPS * BATCH / wall:.1f} examples/s; loss first {losses[0]:.6f} "
        f"last {losses[-1]:.6f}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    box = {"state": state}

    def one_step():
        box["state"], _ = step(box["state"], data, idx[:1], layout)

    profile_device(one_step, step_ms, "train steps", n=3)
    return launches, steady


def phase_wide_cin(device):
    """``xdeepfm_wide_cin_criteo`` (``WIDE_HP``) on the chain: (1)
    ``Predictor.predict`` of N_ROWS rows at BATCH, K1 once a batch and
    never K4, its first WIDE_PARITY_BATCH rows against the CPU; (2)
    WIDE_STEPS stacked Adam steps at WIDE_PARITY_BATCH, card against CPU:
    step 1's gradients with the DNN's relus and the CIN's activations read
    on the card's side of 0, and the loss trace, K1 save, K2 and K3 once a
    step and never K4 or K5; two steps at BATCH under ``CHAIN_SAVE_FMAPS =
    False`` (K1 without fmaps and K2's recompute form once a step), whose
    params are the save form's bits; (3) WIDE_STEPS steps at BATCH timed
    in the order chain, off, off, chain, "off" being ``CIN_CHAIN_MODE =
    "off"`` (K4 and K5 per layer), with each route's busy share and peak
    memory. Returns the launches of the serving call and of the chain's
    timed steps."""
    import torch

    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.layers import cin as cin_layer
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops import cin_chain
    from recman_tpu_torch.serving import Predictor, batch_indices
    from recman_tpu_torch.training import (
        TrainState, create_optimizer, gather_batch, make_train_step_stacked, pack_dataset,
        stack_table_params, unpack_batch,
    )

    t0 = time.perf_counter()
    model = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), WIDE_HP)
    check(model.cin._chain_eligible(True, BATCH, WIDE_HP["embedding_size"]),
          "xdeepfm_wide_cin_criteo: the CIN does not take the chain")
    params = model.init_params(torch.Generator().manual_seed(0))  # default device: CUDA
    check(all(v.is_cuda for v in params.values()), "params not on the GPU")
    data = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    rows = {k: v for k, v in data.items() if k != "y"}

    # (1) serving: one warm-up call of one batch (counted apart), then the rows
    predictor = Predictor(model, params, batch_size=BATCH)
    reset_counts()
    predictor.predict({k: v[:BATCH] for k, v in rows.items()})
    warm = kernel_counts()
    reset_counts()
    t1 = time.perf_counter()
    preds = predictor.predict(rows)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    serve = kernel_counts()
    n_batches = len(batch_indices(N_ROWS, BATCH))
    check_counts(serve, {"K1": n_batches, "K1 save": 0, "K2": 0, "K4": 0, "K5": 0},
                 "xdeepfm_wide_cin_criteo predict")
    check(preds.shape == (N_ROWS,) and bool(np.isfinite(preds).all())
          and bool(((preds > 0) & (preds < 1)).all()), "wide predictions not finite in (0, 1)")
    # a row's prediction does not depend on the other rows of its batch
    params_cpu = {k: v.cpu() for k, v in params.items()}
    t1 = time.perf_counter()
    with torch.inference_mode():
        preds_cpu = model.apply(params_cpu, {k: torch.as_tensor(v[:WIDE_PARITY_BATCH])
                                             for k, v in rows.items()}).numpy()
    cpu_s = time.perf_counter() - t1
    dp = float(np.abs(preds_cpu - preds[:WIDE_PARITY_BATCH]).max())
    check(dp <= WIDE_PRED_TOL, f"wide predict, first rows GPU vs CPU: max|dp| {dp}")
    log(f"xdeepfm_wide_cin_criteo predict: {N_ROWS} rows in {serve_s:.3f} s "
        f"({N_ROWS / serve_s:.1f} examples/s, first call after a one-batch warm-up whose "
        f"launches {warm['K1']} are counted apart); K1 {serve['K1']} = batches {n_batches} "
        f"({N_ROWS // BATCH} of rows and the all-padding batch); its first {WIDE_PARITY_BATCH} "
        f"rows against the CPU max|dp| {dp:.3e} (CPU {cpu_s:.1f} s)")

    # (2) training in stacked storage, card against CPU at WIDE_PARITY_BATCH
    opt = create_optimizer("adam", 1e-3)
    sparams, names = stack_table_params(model, params)
    packed, layout = pack_dataset(data)
    d = {k: torch.as_tensor(v).to(device) for k, v in packed.items()}

    def full_batches(batch_size):
        ix = batch_indices(N_ROWS, batch_size, shuffle_seed=0)
        return ix[(ix >= 0).all(axis=1)]

    idx_np, par_np = full_batches(BATCH), full_batches(WIDE_PARITY_BATCH)[:WIDE_STEPS]
    idx, par = torch.as_tensor(idx_np).to(device), torch.as_tensor(par_np).to(device)
    batch, w = gather_batch(d, par[0])
    ub = unpack_batch(batch, layout)
    reset_counts()
    g_gpu, seen_gpu = recorded_grads(model, sparams, ub, w, names=names)
    torch.cuda.synchronize()
    check_counts(kernel_counts(), {"K1 save": 1, "K2": 1, "K4": 0, "K5": 0},
                 "wide step-1 gradients")
    sp_cpu = {k: v.cpu() for k, v in sparams.items()}
    d_cpu = {k: torch.as_tensor(v) for k, v in packed.items()}
    par_cpu = torch.as_tensor(par_np)
    b_cpu, w_cpu = gather_batch(d_cpu, par_cpu[0])
    t1 = time.perf_counter()
    g_signs, seen_cpu = recorded_grads(model, sp_cpu, unpack_batch(b_cpu, layout), w_cpu,
                                       card=seen_gpu, names=names)
    grads_s = time.perf_counter() - t1
    flips = {part: sign_flips(seen_cpu[part], seen_gpu[part], tol,
                              f"wide step 1 {part}, GPU vs CPU", near_tol=tol)
             for part, tol in (("dnn", DNN_Z_TOL), ("cin", FEED_TOL))}
    worst, worst_k = grads_match(g_signs, g_gpu, "wide step-1 grad GPU vs CPU on the card's signs")
    del g_gpu, g_signs, seen_gpu, seen_cpu

    def trace(p, dd, ix):
        state = TrainState(p, opt.init(p), 0, None)
        return make_train_step_stacked(model, opt, WIDE_STEPS, names)(state, dd, ix, layout)

    reset_counts()
    _, trace_g = trace(sparams, d, par)
    torch.cuda.synchronize()
    check_counts(kernel_counts(), {"K1 save": WIDE_STEPS, "K2": WIDE_STEPS, "K3": WIDE_STEPS,
                                   "K4": 0, "K5": 0}, f"wide {WIDE_STEPS} steps")
    t1 = time.perf_counter()
    _, trace_c = trace(sp_cpu, d_cpu, par_cpu)
    trace_s = time.perf_counter() - t1
    tg, tc = trace_g.cpu().numpy(), trace_c.numpy()
    max_d, final_rel = trace_match(tg, tc, "wide loss trace")
    log(f"xdeepfm_wide_cin_criteo training at batch {WIDE_PARITY_BATCH}, GPU vs CPU: step-1 "
        f"grads on the card's signs worst "
        f"{worst:.3e} ({worst_k}; CPU {grads_s:.1f} s), derivatives read on the other side of 0: "
        f"DNN {flips['dnn']}, CIN {flips['cin']}; {WIDE_STEPS}-step trace GPU {tg.tolist()} CPU "
        f"{tc.tolist()}: max|d| {max_d:.3e}, final rel {final_rel:.3e} (CPU {trace_s:.1f} s)")
    del sp_cpu, d_cpu

    # K2's recompute form: the same two steps' params, bit for bit
    finals = {}
    for save in (True, False):
        cin_chain.CHAIN_SAVE_FMAPS = save
        try:
            state = TrainState(sparams, opt.init(sparams), 0, None)
            reset_counts()
            state, _ = make_train_step_stacked(model, opt, 2, names)(state, d, idx[:2], layout)
            torch.cuda.synchronize()
            counts = kernel_counts()
        finally:
            cin_chain.CHAIN_SAVE_FMAPS = True
        check_counts(counts, {"K1": 0 if save else 2, "K1 save": 2 if save else 0,
                              "K2": 2 if save else 0, "K2 recompute": 0 if save else 2},
                     f"wide steps, CHAIN_SAVE_FMAPS = {save}")
        finals[save] = state.params
    check(all(torch.equal(finals[True][k], finals[False][k]) for k in finals[True]),
          "wide steps: the recompute form's params differ from the save form's")
    log("xdeepfm_wide_cin_criteo under CHAIN_SAVE_FMAPS = False: K1 (no fmaps) and K2 "
        "recompute once a step, params after 2 steps bit-equal to the save form's")
    del finals

    # (3) the chain against the per-layer route, in turns
    step = make_train_step_stacked(model, opt, 1, names)
    state = TrainState(sparams, opt.init(sparams), 0, None)
    results, chain_counts = {}, None
    expect = {"auto": {"K1 save": WIDE_STEPS, "K2": WIDE_STEPS, "K4": 0, "K5": 0},
              "off": {"K1 save": 0, "K2": 0, "K4": 3 * WIDE_STEPS, "K5": 3 * WIDE_STEPS}}
    try:
        for mode in ("auto", "off", "off", "auto"):
            cin_layer.CIN_CHAIN_MODE = mode
            for i in range(2):  # warm-up
                state, _ = step(state, d, idx[i:i + 1], layout)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(WIDE_STEPS + 1)]
            losses = []
            t1 = time.perf_counter()
            events[0].record()
            for i in range(WIDE_STEPS):
                state, loss = step(state, d, idx[i % len(idx_np):i % len(idx_np) + 1], layout)
                losses.append(loss)
                events[i + 1].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3 / WIDE_STEPS
            counts = kernel_counts()
            check_counts(counts, expect[mode], f"wide timed steps [{mode}]")
            check(bool(torch.isfinite(torch.cat(losses)).all()), f"wide steps [{mode}]: loss")
            step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            busy = None
            if mode in results:

                def one_step():
                    nonlocal state
                    state, _ = step(state, d, idx[:1], layout)

                kernel_ms = profile_device(one_step, step_ms, f"wide train steps [{mode}]", n=3)
                busy = kernel_ms / step_ms if kernel_ms else None
            if mode == "auto":
                chain_counts = counts
            results.setdefault(mode, []).append((step_ms, wall, peak, busy))
            log(f"xdeepfm_wide_cin_criteo steps [{'chain' if mode == 'auto' else 'off'}]: "
                f"step (CUDA events, median of {WIDE_STEPS}) {step_ms:.4f} ms, "
                f"{BATCH / step_ms * 1e3:.1f} examples/s; wall {wall:.3f} ms/step; peak "
                f"{peak:.3f} GB over the {base / 1e9:.3f} GB held" +
                (f"; busy share {busy:.4f}" if busy else ""))
    finally:
        cin_layer.CIN_CHAIN_MODE = "auto"
    log("xdeepfm_wide_cin_criteo chain against off (median of the two turns): " + ", ".join(
        f"{'chain' if m == 'auto' else 'off'} {statistics.median(r[0] for r in v):.4f} ms"
        for m, v in results.items()) + f" ({time.perf_counter() - t0:.1f} s)")
    return {"serve": serve, "train": chain_counts}


def phase_tools(device, steady=None):
    """The port's tools at the bench configuration: (a) the bench entry,
    beside phase_training's ``steady`` reading, (b) its numerics check
    without the anchor, (c) the step profile, (d) the ABAB harness, (e)
    the two-process demo's three modes. Returns the launches of (a)'s
    timed steps per step."""
    import torch

    from recman_tpu_torch.layers import cin
    from recman_tpu_torch.ops import cin_chain
    from recman_tpu_torch.ops.embedding import _grad_kernel
    from recman_tpu_torch.tools import abab, bench, multiprocess_demo, profile_step

    card = card_line()
    once = {"K1 save": 1.0, "K2": 1.0, "K3": 1.0}
    steady = steady or {}

    # (a) the bench entry's one line
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(device=device)
    text = buf.getvalue().strip().splitlines()
    check(len(text) == 1, f"(a) the bench entry printed {len(text)} lines")
    line = json.loads(text[0])
    log(f"tools (a) bench line: {text[0]}")
    numbers = ("value", "ms_per_step", "wall_ms_per_step", "mfu", "hbm_util",
               "model_gflops_per_step", "model_hbm_gb_per_step")
    check(line["metric"] == bench.METRIC and all(
        isinstance(line[k], (int, float)) and math.isfinite(line[k]) for k in numbers),
        f"(a) the bench line's numbers: {line}")
    check(line["launches_per_step"] == once, f"(a) launches a step {line['launches_per_step']}")
    check(line["card"] == card, f"(a) the line's card {line['card']!r}, nvidia-smi {card!r}")
    log(f"tools (a) bench: {line['value']:.1f} examples/s over the window ({line['wall_ms_per_step']:.4f} "
        f"ms/step wall, {line['ms_per_step']:.4f} device); train steady "
        f"{steady.get('examples_per_s', float('nan')):.1f} examples/s device, "
        f"{steady.get('wall_examples_per_s', float('nan')):.1f} wall [{card}]; "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (b) the numerics check, no anchor (phase_trainer holds it)
    t0 = time.perf_counter()
    res = bench.run_check(ml_anchor=False, device=device)
    steps = res["steps"]
    check(res["ok"], f"(b) the numerics check: {res}")
    check(res["launches_shipped"] == {k: steps for k in once},
          f"(b) the shipped path's launches {res['launches_shipped']}")
    check(not any(res["launches_reference"].values()),
          f"(b) the plain path launched {res['launches_reference']}")
    log(f"tools (b) check: max|d| {res['max_loss_delta']:.3e}, final rel {res['final_rel_delta']:.3e} "
        f"over {steps} steps; launches shipped {res['launches_shipped']}, plain "
        f"{res['launches_reference']}; {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (c) the step profile
    t0 = time.perf_counter()
    prof = profile_step.run(steps=TOOLS_PROFILE_STEPS, top=12, device=device)
    for name in ("K1", "K2", "K3"):
        syms = profile_step.KERNEL_SYMBOLS[name]
        check(any(s in n for s in syms for n in prof["hand_written"]),
              f"(c) no kernel of {name} ({syms}) under hand-written: {prof['hand_written']}")
    cats = sum(prof["ms_per_step_by_category"].values())
    check(prof["profiled_ms_per_step"] > 0
          and abs(cats - prof["profiled_ms_per_step"]) <= TOOLS_PROFILE_SUM * prof["profiled_ms_per_step"],
          f"(c) categories sum {cats} against the profiled {prof['profiled_ms_per_step']}")
    log(f"tools (c) profile: {prof['profiled_ms_per_step']:.4f} ms/step of kernels; "
        f"by category {prof['ms_per_step_by_category']} [{card}]; "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (d) the ABAB harness
    t0 = time.perf_counter()
    summary = abab.main(TOOLS_ABAB, rounds=TOOLS_ABAB_ROUNDS, steps=TOOLS_ABAB_STEPS, device=device)
    for name, k3 in (("base", 1.0), ("scatter", 0.0)):
        got = [w["launches_per_step"]["K3"] for w in summary["variants"][name]["windows"]]
        check(got == [k3] * TOOLS_ABAB_ROUNDS, f"(d) {name}: K3 a step {got}, expected {k3}")
    check(cin.CIN_CHAIN_MODE == "auto" and cin_chain.CHAIN_SAVE_FMAPS is True
          and _grad_kernel() == "auto", "(d) a flag was not put back")
    log("tools (d) abab: " + "; ".join(
        f"{n} {v['device_ms_per_step']:.4f} ms/step device, {v['wall_ms_per_step']:.4f} wall"
        for n, v in summary["variants"].items()) + f" [{card}]; {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (e) the two-process demo, Gloo ranks on this card
    t0 = time.perf_counter()
    demo = multiprocess_demo.run(2, device=device, grad_kernel="segmat")
    check(demo["ok"], f"(e) the demo: {demo['failures']}")
    for mode, r in demo["modes"].items():
        log(f"tools (e) demo {mode}: {r} [{card}]")
    log(f"tools (e) demo: {time.perf_counter() - t0:.1f} s")
    reset_counts()
    return line["launches_per_step"]


def ml_setup(device, hparams):
    """The example's data and features, a Trainer on ``device`` with the
    example's configuration (plus ``hparams``), its data on the device."""
    from recman_tpu_torch.data import concat_rows, create_ml_features, get_ml_dataset
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.training import Trainer

    train, valid, test, domains = get_ml_dataset(frac=0.5, random_seed=ML_SEED)
    fs = create_ml_features(concat_rows(train, valid), domains)
    hp = {"learning_rate": ML_LR, **hparams}
    trainer = Trainer(XDeepFM(fs, hp), hp, epoch=1, batch_size=128, random_seed=ML_SEED,
                      device=device)
    data, layout = trainer._to_device(fs.transform(train), train["label"])
    return trainer, fs, (train, valid, test), data, layout


def phase_trainer(device):
    """The Trainer slice: (a) parity of 8 steps GPU against CPU, (b) the
    ML-100K anchor with its launch counts, (c) one epoch timed under
    "segmat" and under "scatter". Returns the anchor's launches."""
    import torch

    from recman_tpu_torch.examples.xdeepfm_ml import main as ml_example
    from recman_tpu_torch.ops import cin_chain, segment_matmul
    from recman_tpu_torch.ops.embedding import fused_grad, grad_kernel
    from recman_tpu_torch.training import batch_indices

    # (a) parity: one seed's params, every keep 1, the same 8 batches
    results = []
    for dev in (device, torch.device("cpu")):
        trainer, fs, (train, valid, _), data, layout = ml_setup(dev, {"deep_dropout": (1.0, 1.0, 1.0)})
        if not results:
            params0 = {k: v.cpu() for k, v in trainer.state.params.items()}
        else:
            trainer.state = trainer.state._replace(
                params=params0, opt_state=trainer.optimizer.init(params0))
        idx = batch_indices(len(train["label"]), 128, shuffle_seed=ML_SEED)[:PARITY_STEPS]
        t0 = time.perf_counter()
        with fused_grad(True), grad_kernel("segmat"):
            trace = torch.stack([trainer.fit_on_batch(data, i, layout) for i in idx]).cpu().numpy()
            preds = trainer.predict(fs.transform(valid))
        results.append((trace, preds, time.perf_counter() - t0))
    (tg, pg, sg_s), (tc, pc, sc_s) = results
    max_d, final_rel = trace_match(tg, tc, "trainer loss trace")
    dp = float(np.abs(pg - pc).max())
    check(np.isfinite(pg).all(), "non-finite predictions")
    check(dp <= PARITY_PRED_ABS, f"valid predictions GPU vs CPU: max|dp| {dp} > {PARITY_PRED_ABS}")
    log(f"trainer parity, {PARITY_STEPS} steps lr {ML_LR} (GPU {sg_s:.1f} s, CPU {sc_s:.1f} s): "
        f"trace GPU {tg.tolist()} CPU {tc.tolist()}: max|d| {max_d:.3e}, final rel "
        f"{final_rel:.3e}; valid predictions ({len(pg)}) max|dp| {dp:.3e}, mean|dp| "
        f"{float(np.abs(pg - pc).mean()):.3e}")

    # (b) the anchor, counts from 0
    np.random.seed(ML_SEED)  # draws each epoch's shuffle seed, as in the example
    cin_chain.LAUNCHES = cin_chain.SAVE_LAUNCHES = cin_chain.BWD_LAUNCHES = 0
    segment_matmul.LAUNCHES = segment_matmul.ROWS_LAUNCHES = 0
    t0 = time.perf_counter()
    with grad_kernel("segmat"):
        finder, (logloss, auc) = ml_example(frac=0.5, epoch=1, log_dir="build/anchor_logs",
                                            device=device)
    torch.cuda.synchronize()
    anchor_s = time.perf_counter() - t0
    launches = {"K1": cin_chain.LAUNCHES - cin_chain.SAVE_LAUNCHES,
                "K1 save": cin_chain.SAVE_LAUNCHES, "K2": cin_chain.BWD_LAUNCHES,
                "K3": segment_matmul.LAUNCHES, "K6": segment_matmul.ROWS_LAUNCHES}
    _, _, (train, valid, test), _, _ = ml_setup(device, {})
    n_grid = 2
    steps = n_grid * (len(train["label"]) // 128 + 1)
    eval_batches = n_grid * 2 * sum(len(t["label"]) // 128 + 1 for t in (train, valid)) + \
        len(test["label"]) // 128 + 1
    log(f"anchor (GPU, segmat, {anchor_s:.1f} s): TEST logloss {logloss:.4f} auc {auc:.4f}; "
        f"best lr {finder.best_model.hparams['learning_rate']}; launches {launches} for "
        f"{steps} train steps and {eval_batches} eval batches")
    check(finder.best_model.device == device, "the anchor did not train on the GPU")
    check(ANCHOR_LOGLOSS[0] <= logloss <= ANCHOR_LOGLOSS[1],
          f"anchor TEST logloss {logloss} outside {ANCHOR_LOGLOSS}")
    check(ANCHOR_AUC[0] <= auc <= ANCHOR_AUC[1], f"anchor TEST auc {auc} outside {ANCHOR_AUC}")
    expected = {"K1": eval_batches, "K1 save": steps, "K2": steps, "K3": 0, "K6": 6 * steps}
    check(launches == expected, f"anchor launches {launches}, expected {expected}")

    # (c) one epoch of steps, timed, under each route in turns
    trainer, _, (train, _, _), data, layout = ml_setup(device, {})
    idx = torch.as_tensor(batch_indices(len(train["label"]), 128, shuffle_seed=ML_SEED)).to(device)
    n_steps = idx.shape[0]
    for kind in ("segmat", "scatter", "scatter", "segmat"):
        with grad_kernel(kind):
            for i in range(3):  # warm-up
                trainer.fit_on_batch(data, idx[i], layout)
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(n_steps + 1)]
            k6_before = segment_matmul.ROWS_LAUNCHES
            t0 = time.perf_counter()
            events[0].record()
            for i in range(n_steps):
                trainer.fit_on_batch(data, idx[i], layout)
                events[i + 1].record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k6 = segment_matmul.ROWS_LAUNCHES - k6_before
            check(k6 == (6 * n_steps if kind == "segmat" else 0),
                  f"{kind}: K6 launched {k6} times in {n_steps} steps")
            step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
            log(f"trainer epoch [{kind}]: {n_steps} steps in {wall:.4f} s; step (CUDA events, "
                f"median) {step_ms:.4f} ms, wall {wall * 1e3 / n_steps:.4f} ms/step; "
                f"{len(train['label']) / wall:.1f} examples/s (wall); K6 launches {k6}")

            def one_step():
                trainer.fit_on_batch(data, idx[0], layout)

            profile_device(one_step, step_ms, f"trainer steps [{kind}]", n=3)
    return launches


def reset_counts():
    """Every kernel's launch count to 0."""
    from recman_tpu_torch.ops import cin_chain, cin_interact, segment_matmul

    cin_chain.LAUNCHES = cin_chain.SAVE_LAUNCHES = cin_chain.BWD_LAUNCHES = 0
    cin_chain.RECOMPUTE_LAUNCHES = 0
    segment_matmul.LAUNCHES = segment_matmul.ROWS_LAUNCHES = segment_matmul.VK_LAUNCHES = 0
    cin_interact.LAUNCHES = cin_interact.BWD_LAUNCHES = 0


def kernel_counts():
    from recman_tpu_torch.ops import cin_chain, cin_interact, segment_matmul

    return {"K1": cin_chain.LAUNCHES - cin_chain.SAVE_LAUNCHES,
            "K1 save": cin_chain.SAVE_LAUNCHES, "K2": cin_chain.BWD_LAUNCHES,
            "K2 recompute": cin_chain.RECOMPUTE_LAUNCHES,
            "K3": segment_matmul.LAUNCHES, "K4": cin_interact.LAUNCHES,
            "K5": cin_interact.BWD_LAUNCHES, "K6": segment_matmul.ROWS_LAUNCHES,
            "K7": segment_matmul.VK_LAUNCHES}


def check_counts(counts, expected, what):
    got = {k: counts[k] for k in expected}
    check(got == expected, f"{what}: launches {got}, expected {expected}")


def phase_per_layer(device):
    """The per-layer CIN path at xdeepfm_paper_criteo: (a) parity with the
    CPU, (b) serving, (c) training, (d) cin_remat, (e) live in-chain
    dropout, (f) the Criteo example. Returns the launches of (c)'s fit."""
    import torch

    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.examples.criteo_xdeepfm import main as criteo_example
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.serving import Predictor
    from recman_tpu_torch.training import LogLoss, StreamingAUC, Trainer, batch_indices
    from recman_tpu_torch.training.train_step import gather_batch, loss_and_grads, unpack_batch

    t0 = time.perf_counter()
    fs = create_criteo_features(num_buckets=NUM_BUCKETS)
    data = synthetic_criteo_arrays(PAPER_ROWS + PAPER_VALID, num_buckets=NUM_BUCKETS, seed=2019)
    y_train, y_valid = data["y"][:PAPER_ROWS], data["y"][PAPER_ROWS:]
    x_train = {k: v[:PAPER_ROWS] for k, v in data.items() if k != "y"}
    x_valid = {k: v[PAPER_ROWS:] for k, v in data.items() if k != "y"}

    def trainer(dev, hp=None, batch=PAPER_BATCH):
        hpx = {**PAPER_HP, **(hp or {})}
        return Trainer(XDeepFM(fs, hpx), hpx, metrics=(LogLoss(), StreamingAUC()), epoch=1,
                       batch_size=batch, random_seed=2019, device=dev)

    log(f"per-layer setup: xdeepfm_paper_criteo {PAPER_HP}, {PAPER_ROWS} + {PAPER_VALID} rows, "
        f"{time.perf_counter() - t0:.2f} s")

    # (a) parity: one predict batch, then step 1's gradients and a 2-step
    # trace at batch PARITY_BATCH, card against CPU from the same params
    t_gpu, t_cpu = trainer(device, batch=PARITY_BATCH), trainer("cpu", batch=PARITY_BATCH)
    params0 = {k: v.detach().cpu() for k, v in t_gpu.state.params.items()}
    t_cpu.state = t_cpu.state._replace(params=dict(params0), opt_state=t_cpu.optimizer.init(params0))
    check(all(v.device.type == device.type for v in t_gpu.state.params.values()),
          "params not on the GPU")
    first = {k: v[:PAPER_BATCH] for k, v in x_train.items()}
    reset_counts()
    p_gpu = Predictor(t_gpu.model, t_gpu.state.params, batch_size=PAPER_BATCH).predict(first)
    counts = kernel_counts()
    t1 = time.perf_counter()
    p_cpu = Predictor(t_cpu.model, params0, batch_size=PAPER_BATCH, device="cpu").predict(first)
    cpu_pred_s = time.perf_counter() - t1
    check_counts(counts, {"K1": 0, "K4": 3 * 2}, "parity predict (1 batch + 1 padding batch)")
    dp = float(np.abs(p_gpu - p_cpu).max())
    check(np.isfinite(p_gpu).all() and dp <= PRED_TOL,
          f"per-layer predict GPU vs CPU: max|dp| {dp} > {PRED_TOL}")
    idx = batch_indices(PAPER_ROWS, PARITY_BATCH, shuffle_seed=2019)[:2]
    # step 1 records, per CIN layer, the interaction's output (pre minus the
    # bias) and the L1 mass sum_n |dloss/dpre[o, n]| of the terms whose sum
    # is cin_bias_i's gradient
    from recman_tpu_torch.layers import cin as cin_layer

    real_fm = cin_layer.cin_interact_fm
    results = []
    for tr in (t_gpu, t_cpu):
        t1 = time.perf_counter()
        d, layout = tr._to_device(x_train, y_train)
        batch, w = gather_batch(d, tr._idx(idx[0]))
        pres, masses = [], []

        def recording(x0c, xkc, wt, pres=pres, masses=masses):
            out = real_fm(x0c, xkc, wt)
            pres.append(out.detach().cpu())
            masses.append(None)
            out.register_hook(
                lambda g, i=len(masses) - 1: masses.__setitem__(i, g.abs().sum(1).cpu()))
            return out

        cin_layer.cin_interact_fm = recording
        try:
            loss, grads = loss_and_grads(tr.model, tr.state.params, unpack_batch(batch, layout), w)
        finally:
            cin_layer.cin_interact_fm = real_fm
        trace = torch.stack([tr.fit_on_batch(d, i, layout) for i in idx]).cpu().numpy()
        results.append((loss.item(), {k: g.cpu() for k, g in grads.items()}, trace,
                        time.perf_counter() - t1, pres, masses))
    (lg, gg, tg, sg_s, pres_g, _), (lc, gc, tc, sc_s, pres_c, masses_c) = results
    n_layers = len(PAPER_HP["cin_cross_layer_units"])
    check(len(pres_g) == len(pres_c) == n_layers and all(m is not None for m in masses_c),
          "the parity step did not run the per-layer path")
    rel, bias_rel, flips = {}, {}, []
    for i in range(n_layers):
        bias = params0[f"cin_bias_{i}"][:, None]
        flips.append(int(((pres_g[i] + bias > 0) != (pres_c[i] + bias > 0)).sum()))
    for k in gc:
        diff = (gg[k] - gc[k]).abs()
        err, scale = diff.max().item(), gc[k].abs().max().item()
        rel[k] = err / scale if scale else err
        if k.startswith("cin_bias_"):
            # a bias's gradient is a sum over B*D terms that cancel: one
            # leaky_relu derivative read on the other side of 0 (pre within
            # the f32 sum-order difference of 0) moves it by 0.8 of a term,
            # so it is held to its terms' L1 mass
            mass = masses_c[int(k.rsplit("_", 1)[1])]
            bias_rel[k] = (diff / mass).max().item()
            check(bool((diff <= GRAD_TOL * mass).all()),
                  f"per-layer step-1 grad {k}: max|d|/mass {bias_rel[k]} > {GRAD_TOL}")
        else:
            check(err <= GRAD_TOL * scale, f"per-layer step-1 grad {k}: max|d| {err} > {GRAD_TOL} * {scale}")
    max_d, final_rel = trace_match(tg, tc, "per-layer trace")
    worst = max((k for k in rel if k not in bias_rel), key=rel.get)
    log(f"per-layer parity: predict {PAPER_BATCH} rows max|dp| {dp:.3e} (CPU {cpu_pred_s:.1f} s); "
        f"batch {PARITY_BATCH}: step-1 loss {lg:.7f} vs {lc:.7f}, grads max|d|/max|ref| worst "
        f"{rel[worst]:.3e} ({worst}); CIN biases max|d|/max|ref| "
        f"{ {k: f'{rel[k]:.3e}' for k in bias_rel} }, max|d|/L1 mass of the terms "
        f"{ {k: f'{v:.3e}' for k, v in bias_rel.items()} }; leaky_relu derivatives read on the "
        f"other side of 0, per layer, of {pres_c[0].numel()}: {flips}; trace GPU "
        f"{tg.tolist()} CPU {tc.tolist()}: max|d| {max_d:.3e}, final rel {final_rel:.3e} "
        f"(GPU {sg_s:.1f} s, CPU {sc_s:.1f} s)")
    del t_cpu, results

    # (b) serving: Predictor at batch 4096 over PAPER_ROWS rows
    predictor = Predictor(t_gpu.model, t_gpu.state.params, batch_size=PAPER_BATCH)
    n_batches = PAPER_ROWS // PAPER_BATCH + 1
    reset_counts()
    t1 = time.perf_counter()
    preds = predictor.predict(x_train)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    check_counts(kernel_counts(), {"K1": 0, "K1 save": 0, "K4": 3 * n_batches, "K5": 0},
                 f"serving {n_batches} batches")
    check(preds.shape == (PAPER_ROWS,) and bool(np.isfinite(preds).all())
          and bool(((preds > 0) & (preds < 1)).all()), "serving predictions")
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        predictor.predict(x_train)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wall = statistics.median(walls)
    dev = {k: torch.as_tensor(v[:PAPER_BATCH]).cuda() for k, v in x_train.items()}

    def forward():
        with torch.inference_mode():
            return t_gpu.model.apply(predictor.params, dev)

    batch_ms = cuda_time_ms(forward, reps=20)
    log(f"per-layer serving: first predict {first_s:.3f} s; steady {wall * 1e3:.3f} ms per call of "
        f"{PAPER_ROWS} rows ({n_batches} batches), {PAPER_ROWS / wall:.1f} examples/s; one batch "
        f"forward (device) {batch_ms:.4f} ms, {PAPER_BATCH / batch_ms * 1e3:.1f} examples/s; "
        f"K4 {3 * n_batches} launches")
    profile_device(forward, batch_ms, "per-layer batch forwards")
    del predictor, dev, t_gpu

    # (c) training: Trainer.fit, one epoch, then evaluate; then 16 timed steps
    tr = trainer(device)
    steps = PAPER_ROWS // PAPER_BATCH + 1
    eval_batches = 2 * steps + len(y_valid) // PAPER_BATCH + 1  # epoch 0 and 1 evals, valid
    reset_counts()
    t1 = time.perf_counter()
    tr.fit(x_train, y_train)
    logloss, auc = tr.evaluate(x_valid, y_valid)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    fit_launches = kernel_counts()
    check_counts(fit_launches, {"K1": 0, "K1 save": 0, "K2": 0, "K4": 3 * (steps + eval_batches),
                                "K5": 3 * steps}, f"fit ({steps} steps, {eval_batches} eval batches)")
    check(np.isfinite(tr.last_mean_loss) and np.isfinite(logloss) and np.isfinite(auc),
          "non-finite fit loss or metrics")
    log(f"per-layer fit: {steps} steps + {eval_batches} eval batches in {fit_s:.2f} s; mean loss "
        f"{tr.last_mean_loss:.5f}; VALID logloss {logloss:.4f} auc {auc:.4f}; launches {fit_launches}")
    d, layout = tr._to_device(x_train, y_train)
    idx = tr._idx(batch_indices(PAPER_ROWS, PAPER_BATCH, shuffle_seed=7))
    for i in range(2):  # warm-up
        tr.fit_on_batch(d, idx[i], layout)
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n_timed = PAPER_ROWS // PAPER_BATCH
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n_timed + 1)]
    losses = []
    t1 = time.perf_counter()
    events[0].record()
    for i in range(n_timed):
        losses.append(tr.fit_on_batch(d, idx[i], layout))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    check_counts(kernel_counts(), {"K1": 0, "K1 save": 0, "K2": 0, "K4": 3 * n_timed,
                                   "K5": 3 * n_timed}, f"{n_timed} timed steps")
    losses = torch.stack(losses).cpu().numpy()
    check(bool(np.isfinite(losses).all()), "non-finite loss in the timed steps")
    step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    log(f"per-layer train steady: {n_timed} steps; step (CUDA events, median) {step_ms:.4f} ms, "
        f"{PAPER_BATCH / step_ms * 1e3:.1f} examples/s; wall {wall * 1e3 / n_timed:.3f} ms/step, "
        f"{n_timed * PAPER_BATCH / wall:.1f} examples/s; loss first {losses[0]:.6f} last "
        f"{losses[-1]:.6f}; peak memory {peak / 1e9:.3f} GB ({(peak - base_mem) / 1e9:.3f} GB "
        f"over the {base_mem / 1e9:.3f} GB held before the steps)")

    def one_step():
        tr.fit_on_batch(d, idx[0], layout)

    profile_device(one_step, step_ms, "per-layer train steps", n=3)

    # (d) cin_remat: step 1's gradients with and without, launches, peak memory
    tr_r = trainer(device, {"cin_remat": True})
    batch, w = gather_batch(d, idx[0])
    ub = unpack_batch(batch, layout)
    runs = []
    for model, k4 in ((tr.model, 3), (tr_r.model, 6)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss, grads = loss_and_grads(model, tr.state.params, ub, w)
        torch.cuda.synchronize()
        check_counts(kernel_counts(), {"K1": 0, "K4": k4, "K5": 3}, f"one step, remat={k4 == 6}")
        runs.append((loss.item(), grads, torch.cuda.max_memory_allocated() - before))
    (la, ga, pa), (lb, gb, pb) = runs
    equal = all(torch.equal(ga[k], gb[k]) for k in ga)
    if not equal:
        max_rel_err([ga[k] for k in ga], [gb[k] for k in ga], K5_TOL, "remat gradients")
    log(f"per-layer cin_remat: loss {la:.7f} vs {lb:.7f}; gradients "
        f"{'bit-equal' if equal else 'within K5_TOL'}; K4 6 a step (3 without); peak memory of "
        f"the step over what it holds before: {pb / 1e9:.3f} GB with remat, {pa / 1e9:.3f} GB "
        f"without")
    del tr_r, runs, ga, gb

    # (e) live in-chain dropout: two steps on the per-layer path
    tr_d = trainer(device, {"cin_dropout": (1, 0.5, 0.5, 0.5)})
    reset_counts()
    dl = torch.stack([tr_d.fit_on_batch(d, idx[i], layout) for i in range(2)]).cpu().numpy()
    check_counts(kernel_counts(), {"K1": 0, "K1 save": 0, "K2": 0, "K4": 6, "K5": 6},
                 "2 steps with live CIN dropout")
    check(bool(np.isfinite(dl).all()), "non-finite loss with live CIN dropout")
    log(f"per-layer live dropout (keeps (1, 0.5, 0.5, 0.5)): losses {dl.tolist()}")
    del tr_d, tr, d

    # (f) the Criteo example at its defaults with the paper's k
    reset_counts()
    t1 = time.perf_counter()
    ex_trainer, (ex_logloss, ex_auc) = criteo_example(embedding_size=10, device=device)
    torch.cuda.synchronize()
    counts = kernel_counts()
    check(ex_trainer.device == device, "the example did not train on the GPU")
    check(counts["K4"] > 0 and counts["K5"] > 0 and counts["K1"] == 0 and counts["K1 save"] == 0,
          f"example launches {counts}")
    check(np.isfinite(ex_logloss) and np.isfinite(ex_auc) and ex_auc > 0.5,
          f"example VALID logloss {ex_logloss}, auc {ex_auc}")
    log(f"criteo example (embedding_size 10, 200,000 rows, batch 4096, one epoch) in "
        f"{time.perf_counter() - t1:.1f} s: VALID logloss {ex_logloss:.4f} auc {ex_auc:.4f}; "
        f"launches {counts}")
    return fit_launches


def grads_match(ref, got, what, tol=GRAD_TOL):
    """Every gradient of ``got`` within tol * max|ref| of ``ref``'s (on the
    CPU); returns the worst ratio and its param."""
    rel = {}
    for k in ref:
        err = (got[k].cpu() - ref[k].cpu()).abs().max().item()
        scale = ref[k].abs().max().item()
        rel[k] = err / scale if scale else err
        check(err <= tol * scale, f"{what} {k}: max|d| {err} > {tol} * {scale}")
    worst = max(rel, key=rel.get)
    return rel[worst], worst


def rel_err(ref, got):
    """max|ref - got| over max|ref| (over 1 where ref is all 0)."""
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale or 1.0)


def recorded_grads(model, params, ub, w, card=None, names=None):
    """Step-1 gradients of a model with a DNN and, if it has a CIN, one
    that takes the chain with saved fmaps, recording each DNN layer's
    pre-activation and the CIN's fmaps (on the CPU); ``names``: the params
    are in stacked storage. With ``card``, another run's record: where this run's
    pre-activation or fmap has the other sign than the card's, the
    activation (piecewise linear through 0) is taken on the card's side of
    0, and its derivative with it; every value is this run's own but the
    fmap at such an element, which K2 reads for its sign, and which is the
    card's. Returns (grads, {"dnn": [...], "cin": [...]})."""
    import torch

    from recman_tpu_torch.ops import cin_chain
    from recman_tpu_torch.training.train_step import loss_and_grads

    real_act, real_fwd = model.dnn.activation, cin_chain.cin_chain_fwd
    seen = {"dnn": [], "cin": []}

    def dnn_act(z):
        i = len(seen["dnn"])
        seen["dnn"].append(z.detach().cpu())
        if card is None:
            return real_act(z)
        pos = card["dnn"][i].to(z.device) > 0
        return torch.where(pos == (z > 0), real_act(z), torch.where(pos, z, -real_act(-z)))

    def fwd(x0c, ws, bs, units, d, act="leaky_relu", save=False):
        out = real_fwd(x0c, ws, bs, units, d, act, save)
        if save:
            n = len(units)
            seen["cin"] = [f.cpu() for f in out[n:]]
            if card is not None:
                out = (*out[:n], *(torch.where((f > 0) == (c > 0), f, c.to(f.device))
                                   for f, c in zip(out[n:], card["cin"])))
        return out

    model.dnn.activation, cin_chain.cin_chain_fwd = dnn_act, fwd
    try:
        grads = loss_and_grads(model, params, ub, w, names=names)[1]
    finally:
        model.dnn.activation, cin_chain.cin_chain_fwd = real_act, real_fwd
    check(len(seen["dnn"]) == len(model.dnn.hidden_units)
          and bool(seen["cin"]) == hasattr(model, "cin"),
          "the step did not run the DNN and the CIN chain with saved fmaps")
    return grads, seen


def trace_match(tg, tc, what):
    max_d = float(np.abs(tg - tc).max())
    final_rel = float(abs(tg[-1] - tc[-1]) / max(abs(tc[-1]), 1e-9))
    check(np.isfinite(tg).all() and np.isfinite(tc).all(), f"{what}: non-finite loss")
    check(max_d <= TRACE_ABS and final_rel <= TRACE_REL,
          f"{what} GPU vs CPU: max|d| {max_d} (bound {TRACE_ABS}), final rel {final_rel} "
          f"(bound {TRACE_REL})")
    return max_d, final_rel


def timed_steps(trainer, data, idx, layout, n):
    """n ``fit_on_batch`` steps after 2 of warm-up: (device ms per step,
    median of CUDA events; wall ms per step; peak memory over what was held
    before, bytes; the launches of the n steps)."""
    import torch

    for i in range(2):
        trainer.fit_on_batch(data, idx[i], layout)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(n):
        losses.append(trainer.fit_on_batch(data, idx[i % idx.shape[0]], layout))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    counts = kernel_counts()
    check(bool(torch.isfinite(torch.stack(losses)).all()), "non-finite loss in the timed steps")
    step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    return step_ms, wall, torch.cuda.max_memory_allocated() - base, counts


def large_batch_trainer(device, batch, hp=None, seed=2019):
    """A Trainer of the large-batch slice's model (the reference's
    criteo_large_batch configuration) with Adam and the warmup-plus-cosine
    schedule of a 30-step epoch."""
    from recman_tpu_torch.data import create_criteo_features
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.training import LogLoss, StreamingAUC, Trainer, large_batch_schedule

    hpx = {**LARGE_HP, "learning_rate": large_batch_schedule(1e-3, batch, 8192, 2, 30),
           **(hp or {})}
    return Trainer(XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), hpx), hpx,
                   metrics=(LogLoss(), StreamingAUC()), epoch=1, batch_size=batch,
                   random_seed=seed, device=device)


def phase_large_batch(device):
    """The large-batch slice: (a) parity with the CPU at batch 4096, (b) the
    example at batch 65,536 with saved fmaps, (c) the same steps with K2's
    recompute form, (d) the Criteo example's large-batch recipe. Returns
    the launches of the recompute form's timed steps."""
    import torch

    from recman_tpu_torch.data import synthetic_criteo_arrays
    from recman_tpu_torch.examples.criteo_large_batch import main as large_batch_example
    from recman_tpu_torch.examples.criteo_xdeepfm import main as criteo_example
    from recman_tpu_torch.ops import cin_chain
    from recman_tpu_torch.training import batch_indices, create_optimizer, large_batch_schedule
    from recman_tpu_torch.training.train_step import gather_batch, loss_and_grads, unpack_batch

    # (a) parity at batch PARITY_LARGE: step-1 gradients in both forms, and
    # a 4-step trace with large_batch_schedule and lamb, card against CPU
    t0 = time.perf_counter()
    data = synthetic_criteo_arrays(PARITY_LARGE * CPU_STEPS, num_buckets=NUM_BUCKETS, seed=5)
    x = {k: v for k, v in data.items() if k != "y"}
    idx = batch_indices(PARITY_LARGE * CPU_STEPS, PARITY_LARGE, shuffle_seed=1)[:CPU_STEPS]
    hp = {"optimizer": create_optimizer(
        "lamb", large_batch_schedule(1e-3, PARITY_LARGE, 256, 2, CPU_STEPS))}
    tg, tc = (large_batch_trainer(dev, PARITY_LARGE, hp) for dev in (device, "cpu"))
    params0 = {k: v.detach().cpu() for k, v in tg.state.params.items()}
    tc.state = tc.state._replace(params=dict(params0), opt_state=tc.optimizer.init(params0))
    grads, traces = {}, []
    for where, tr in (("gpu", tg), ("cpu", tc)):
        d, layout = tr._to_device(x, data["y"])
        batch, w = gather_batch(d, tr._idx(idx[0]))
        ub = unpack_batch(batch, layout)
        for save in (True, False):
            cin_chain.CHAIN_SAVE_FMAPS = save
            reset_counts()
            grads[where, save] = loss_and_grads(tr.model, tr.state.params, ub, w)[1]
            counts = kernel_counts()
            if where == "gpu":
                check_counts(counts, {"K1 save": int(save), "K2": int(save),
                                      "K2 recompute": int(not save), "K3": 1},
                             f"parity step, CHAIN_SAVE_FMAPS={save}")
        cin_chain.CHAIN_SAVE_FMAPS = True
        traces.append(torch.stack([tr.fit_on_batch(d, i, layout) for i in idx]).cpu().numpy())
    bits = all(torch.equal(grads["gpu", True][k], grads["gpu", False][k]) for k in params0)
    check(bits, "step-1 gradients on the card differ between the two CIN forms")
    w_save, k_save = grads_match(grads["cpu", True], grads["gpu", True], "large-batch step-1 grad")
    w_rec, k_rec = grads_match(grads["cpu", False], grads["gpu", False],
                               "large-batch step-1 grad (recompute)")
    max_d, final_rel = trace_match(traces[0], traces[1], "large-batch lamb trace")
    log(f"large-batch parity at batch {PARITY_LARGE} ({time.perf_counter() - t0:.1f} s): step-1 "
        f"grads GPU vs CPU worst {w_save:.3e} ({k_save}) with saved fmaps, {w_rec:.3e} ({k_rec}) "
        f"recomputed; the two forms bit-equal on the card; lamb + warmup-cosine trace GPU "
        f"{traces[0].tolist()} CPU {traces[1].tolist()}: max|d| {max_d:.3e}, final rel "
        f"{final_rel:.3e}")
    del tg, tc, grads

    # (b) the example at batch 65,536, saved fmaps
    reset_counts()
    t0 = time.perf_counter()
    trainer, (logloss, auc) = large_batch_example(batch_size=LARGE_BATCH, rows=LARGE_ROWS,
                                                  device=device)
    torch.cuda.synchronize()
    example_s = time.perf_counter() - t0
    counts = kernel_counts()
    split = int(LARGE_ROWS * 0.95)
    steps = split // LARGE_BATCH + 1
    eval_batches = 2 * steps + (LARGE_ROWS - split) // LARGE_BATCH + 1
    check(trainer.device.type == "cuda", "the large-batch example did not train on the GPU")
    check(np.isfinite(logloss) and np.isfinite(auc) and auc > 0.5,
          f"large-batch example VALID logloss {logloss}, auc {auc}")
    check_counts(counts, {"K1": eval_batches, "K1 save": steps, "K2": steps, "K2 recompute": 0,
                          "K3": steps}, f"large-batch example ({steps} steps, {eval_batches} eval "
                          f"batches)")
    log(f"large-batch example (batch {LARGE_BATCH}, {LARGE_ROWS} rows, {steps} steps, Adam "
        f"warmup+cosine) in {example_s:.1f} s: VALID logloss {logloss:.4f} auc {auc:.4f}; "
        f"launches {counts}")

    # (b, c) the same steps timed with saved fmaps and recomputed, in turns
    d, layout = trainer._to_device(*timed_data(LARGE_BATCH))
    idx = trainer._idx(batch_indices(TIMED_LARGE * LARGE_BATCH, LARGE_BATCH, shuffle_seed=3))
    batch, w = gather_batch(d, idx[0])
    ub = unpack_batch(batch, layout)
    results = {}
    for save in (True, False, False, True):
        cin_chain.CHAIN_SAVE_FMAPS = save
        step_ms, wall, peak, counts = timed_steps(trainer, d, idx, layout, TIMED_LARGE)
        n = TIMED_LARGE
        check_counts(counts, {"K1": 0 if save else n, "K1 save": n if save else 0,
                              "K2": n if save else 0, "K2 recompute": 0 if save else n, "K3": n},
                     f"{n} timed steps, CHAIN_SAVE_FMAPS={save}")
        results.setdefault(save, []).append((step_ms, wall, peak))
        if not save:
            rec_launches = counts
        log(f"large-batch steps [{'saved fmaps' if save else 'recomputed'}]: step (CUDA events, "
            f"median) {step_ms:.4f} ms, {LARGE_BATCH / step_ms * 1e3:.1f} examples/s; wall "
            f"{wall:.3f} ms/step, {LARGE_BATCH / wall * 1e3:.1f} examples/s; peak memory "
            f"{peak / 1e9:.3f} GB over what was held before")
    cin_chain.CHAIN_SAVE_FMAPS = True
    peak_save = min(p for _, _, p in results[True])
    peak_rec = max(p for _, _, p in results[False])
    check(peak_rec < peak_save, f"recompute form's peak {peak_rec} not below the save form's "
          f"{peak_save}")
    for save in (True, False):
        cin_chain.CHAIN_SAVE_FMAPS = save

        def one_step():
            trainer.fit_on_batch(d, idx[0], layout)

        profile_device(one_step, statistics.median(r[0] for r in results[save]),
                       f"large-batch train steps [{'saved fmaps' if save else 'recomputed'}]", n=3)
    cin_chain.CHAIN_SAVE_FMAPS = True
    grads = {}
    for save in (True, False):
        cin_chain.CHAIN_SAVE_FMAPS = save
        grads[save] = loss_and_grads(trainer.model, trainer.state.params, ub, w)[1]
    cin_chain.CHAIN_SAVE_FMAPS = True
    check(all(torch.equal(grads[True][k], grads[False][k]) for k in grads[True]),
          f"batch {LARGE_BATCH}: step gradients differ between the two CIN forms")
    log(f"large-batch, batch {LARGE_BATCH}: step gradients bit-equal in the two forms; peak "
        f"memory of a step over what it holds: saved fmaps {peak_save / 1e9:.3f} GB, recomputed "
        f"{peak_rec / 1e9:.3f} GB")
    del trainer, d, grads

    # (d) the Criteo example's large-batch recipe
    reset_counts()
    t0 = time.perf_counter()
    ex_trainer, (ex_logloss, ex_auc) = criteo_example(rows=RECIPE_ROWS, large_batch=True,
                                                      device=device)
    torch.cuda.synchronize()
    counts = kernel_counts()
    check(ex_trainer.batch_size == LARGE_BATCH and ex_trainer.device.type == "cuda",
          "the large-batch recipe did not train at batch 65,536 on the GPU")
    check(np.isfinite(ex_logloss) and np.isfinite(ex_auc) and ex_auc > 0.5,
          f"recipe VALID logloss {ex_logloss}, auc {ex_auc}")
    check(counts["K1 save"] == counts["K2"] == counts["K3"] > 0, f"recipe launches {counts}")
    log(f"criteo example, large-batch recipe ({RECIPE_ROWS} rows, batch {ex_trainer.batch_size}) "
        f"in {time.perf_counter() - t0:.1f} s: VALID logloss {ex_logloss:.4f} auc {ex_auc:.4f}; "
        f"launches {counts}")
    return rec_launches


def timed_data(batch):
    from recman_tpu_torch.data import synthetic_criteo_arrays

    data = synthetic_criteo_arrays(TIMED_LARGE * batch, num_buckets=NUM_BUCKETS, seed=7)
    return {k: v for k, v in data.items() if k != "y"}, data["y"]


def phase_split_lookup(device):
    """The split lookup at the bench configuration, per-table step at batch
    8192: K7 against K3 and the split route against concat (launches,
    gradients), card against CPU at step 1 (``recorded_grads``: the DNN's
    pre-activations, the CIN's fmaps and their sign differences bounded,
    every gradient held on the card's signs), then concat / split with K3
    / split with K7 timed in turns. Returns the launches of the K7 steps."""
    import torch

    from recman_tpu_torch.ops import embedding as emb_ops
    from recman_tpu_torch.training import batch_indices
    from recman_tpu_torch.training.train_step import gather_batch, unpack_batch

    def split_grads(params, ub, w, route, card=None):
        emb_ops.SEGMAT_VK_OUT = route == "split K7"
        with emb_ops.split_lookup("off" if route == "concat" else "on"):
            reset_counts()
            grads, seen = recorded_grads(tr.model, params, ub, w, card)
        emb_ops.SEGMAT_VK_OUT = False
        return grads, kernel_counts(), seen

    # step 1 at batch BATCH on the card: K7 against K3, and the split route
    # against concat, whose forward gives the same rows (so every gradient
    # but the lookups' is the same bits)
    t0 = time.perf_counter()
    tr = large_batch_trainer(device, BATCH, {"learning_rate": 1e-3})
    d, layout = tr._to_device(*timed_data(BATCH))
    idx = tr._idx(batch_indices(TIMED_LARGE * BATCH, BATCH, shuffle_seed=4))
    batch, w = gather_batch(d, idx[0])
    ub = unpack_batch(batch, layout)
    grads, counts = {}, {}
    for route in ("split K7", "split K3", "concat"):
        grads[route], counts[route], seen = split_grads(tr.state.params, ub, w, route)
        if route == "split K7":
            seen_gpu = seen
        check_counts(counts[route], {"K7": int(route == "split K7"),
                                     "K3": int(route != "split K7")}, f"step 1 [{route}]")
    e_vk, k_vk = grads_match(grads["split K3"], grads["split K7"], "split K7 vs K3 grad",
                             tol=K3_TOL)
    e_cat, k_cat = grads_match(grads["concat"], grads["split K7"], "split K7 vs concat grad",
                               tol=K3_TOL)
    same = sum(torch.equal(grads["concat"][k], grads["split K7"][k]) for k in grads["concat"])
    # the same step on the CPU (the twins), as it runs and with every
    # derivative of a DNN or CIN activation read on the card's side of 0
    t1 = time.perf_counter()
    params_cpu = {k: v.cpu() for k, v in tr.state.params.items()}
    ub_cpu = {k: v.cpu() for k, v in ub.items()}
    g_cpu, _, seen_cpu = split_grads(params_cpu, ub_cpu, w.cpu(), "split K7")
    g_signs = split_grads(params_cpu, ub_cpu, w.cpu(), "split K7", card=seen_gpu)[0]
    cpu_s = time.perf_counter() - t1
    g_gpu = {k: v.cpu() for k, v in grads["split K7"].items()}
    rel = {k: rel_err(g_cpu[k], g_gpu[k]) for k in g_cpu}
    by_flips = {k: rel_err(g_cpu[k], g_signs[k]) for k in g_cpu}
    on_signs = {k: rel_err(g_signs[k], g_gpu[k]) for k in g_cpu}
    worst = sorted(rel, key=rel.get, reverse=True)[:3]
    worst_sgn = max(on_signs, key=on_signs.get)

    def fmt(r):
        return "{" + ", ".join(f"{k}: {r[k]:.3e}" for k in worst) + "}"

    log(f"step-1 grads at batch {BATCH}, GPU (K7) vs CPU (CPU {cpu_s:.1f} s), max|d|/max|ref| "
        f"of the worst three {fmt(rel)}; the CPU's own signs against the card's move them by "
        f"{fmt(by_flips)}; GPU vs CPU on the card's signs {fmt(on_signs)}, worst of all "
        f"{on_signs[worst_sgn]:.3e} ({worst_sgn})")
    flips = {part: sign_flips(seen_cpu[part], seen_gpu[part], tol, f"step 1 {part}, GPU vs CPU",
                              near_tol=tol)
             for part, tol in (("dnn", DNN_Z_TOL), ("cin", FEED_TOL))}
    grads_match(g_signs, g_gpu, "split step-1 grad GPU vs CPU on the card's signs")
    log(f"split lookup ({time.perf_counter() - t0:.1f} s): step-1 grads at batch {BATCH}, K7 vs "
        f"K3 worst {e_vk:.3e} ({k_vk}), split K7 vs concat worst {e_cat:.3e} ({k_cat}; "
        f"{same} of {len(grads['concat'])} params bit-equal); GPU (K7) vs CPU: derivatives read "
        f"on the other side of 0, DNN {flips['dnn']} of {sum(z.numel() for z in seen_cpu['dnn'])}"
        f", CIN {flips['cin']} of {sum(f.numel() for f in seen_cpu['cin'])}; every gradient "
        f"within {GRAD_TOL} of max|ref| on the card's signs (worst {on_signs[worst_sgn]:.3e})")
    del grads, g_gpu, g_cpu, g_signs, seen_gpu, seen_cpu

    results = {}
    for route in ("concat", "split K3", "split K7", "split K7", "split K3", "concat"):
        emb_ops.SEGMAT_VK_OUT = route == "split K7"
        with emb_ops.split_lookup("off" if route == "concat" else "on"):
            step_ms, wall, peak, c = timed_steps(tr, d, idx, layout, 3)
            expected = {"K7": 3 * (route == "split K7"),
                        "K3": 3 * (route != "split K7")}
            check_counts(c, expected, f"3 steps [{route}]")
            results.setdefault(route, []).append((step_ms, wall))
            if route in results and len(results[route]) == 2:

                def one_step():
                    tr.fit_on_batch(d, idx[0], layout)

                profile_device(one_step, step_ms, f"split-lookup train steps [{route}]", n=3)
            if route == "split K7":
                k7_launches = c
        log(f"split-lookup steps [{route}]: step (CUDA events, median of 3) {step_ms:.4f} ms, "
            f"{BATCH / step_ms * 1e3:.1f} examples/s; wall {wall:.3f} ms/step")
    emb_ops.SEGMAT_VK_OUT = False
    log("split-lookup summary (median of the two turns): " + ", ".join(
        f"{r} {statistics.median(x[0] for x in v):.4f} ms" for r, v in results.items()))
    return k7_launches


def preempting(directory, at_step, save_seconds, base=None, **kw):
    """A ``Resilience`` (or a subclass of ``base``, ``parallel.
    MeshResilience`` on a mesh) that raises a real SIGTERM at the boundary
    of global step ``at_step`` (the handler ``fit`` installed catches it;
    None: no signal) and appends the seconds of each save that writes a
    checkpoint to ``save_seconds``."""
    import signal

    import torch

    from recman_tpu_torch.training import Resilience

    class Preempting(base or Resilience):
        def step_boundary(self, trainer, step, epoch, extra=None):
            if at_step is not None and step == at_step:
                signal.raise_signal(signal.SIGTERM)
            super().step_boundary(trainer, step, epoch, extra)

        def save(self, trainer, step, epoch, extra=None):
            if step == self._last_saved_step:
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save(trainer, step, epoch, extra)
            save_seconds.append(time.perf_counter() - t0)

    return Preempting(directory, **kw)


def states_equal(a, b, what):
    """Params, every optimizer-state tensor, the step and (where both have
    one) the generator's state of two TrainStates, bit for bit; b's
    tensors are read on a's devices. Returns the optimizer-state tensors
    compared."""
    import torch

    from recman_tpu_torch.ckpt.checkpoint import _flatten

    check(list(a.params) == list(b.params), f"{what}: param names differ")
    for k, v in a.params.items():
        check(torch.equal(v, b.params[k].to(v.device)), f"{what}: param {k} differs")
    fa, fb = _flatten(a.opt_state), _flatten(b.opt_state)
    check([p for p, _ in fa] == [p for p, _ in fb], f"{what}: optimizer state paths differ")
    n = 0
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            check(x.dtype == y.dtype and torch.equal(x, y.to(x.device)),
                  f"{what}: optimizer state {path} differs")
            n += 1
    check(a.step == b.step, f"{what}: step {a.step} != {b.step}")
    if a.generator is not None and b.generator is not None:
        check(torch.equal(a.generator.get_state(), b.generator.get_state()),
              f"{what}: dropout generator state differs")
    return n


def write_criteo_tsv(path, rows, seed):
    """A Criteo-format TSV: a 0/1 label, 13 integer fields (about 20%
    empty, some negative) and 26 hex tokens (Zipf-skewed, about 10%
    empty), tab-separated, one row a line."""
    rs = np.random.RandomState(seed)
    cols = [["1" if c else "0" for c in (rs.rand(rows) < 0.25).tolist()]]
    for _ in range(13):
        v, empty = rs.randint(-3, 1000, rows).tolist(), (rs.rand(rows) < 0.2).tolist()
        cols.append(["" if e else str(x) for x, e in zip(v, empty)])
    for _ in range(26):
        v, empty = (rs.zipf(1.2, rows) % 1_000_003).tolist(), (rs.rand(rows) < 0.1).tolist()
        cols.append(["" if e else f"{x:08x}" for x, e in zip(v, empty)])
    with open(path, "w") as f:
        f.write("\n".join("\t".join(r) for r in zip(*cols)))
        f.write("\n")


@contextlib.contextmanager
def scatter_counter():
    """Wrap the lookups' ``index_add_`` route (nondeterministic on CUDA)
    with a call count for the block's length; yields the count's holder."""
    from recman_tpu_torch.ops import embedding as emb

    calls = [0]
    inner = emb._scatter_sorted_rows

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    emb._scatter_sorted_rows = counted
    try:
        yield calls
    finally:
        emb._scatter_sorted_rows = inner


def resilient_trainer(device):
    from recman_tpu_torch.data import create_criteo_features
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.training import LogLoss, Trainer

    return Trainer(XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), RESUME_HP), RESUME_HP,
                   metrics=(LogLoss(),), epoch=2, batch_size=BATCH, random_seed=2019,
                   device=device)


def dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_resilience(device):
    """Checkpoints, resilient training and streaming at full width: (a) a
    resilient ``fit`` preempted by a real SIGTERM at step 9 and resumed
    by a fresh Trainer, bit-equal to the uninterrupted run, its launches
    counted; (b) ``Predictor.from_checkpoint`` on the final checkpoint, on
    the card and on the CPU, and the checkpoint restored on the CPU; (c) a Criteo TSV parsed natively in full and
    in chunks, ``fit_stream`` preempted inside chunk 2 of epoch 2 and
    resumed, bit-equal, and ``predict_stream`` against ``predict``.
    Returns the resumed runs' launches."""
    import json as _json
    import os
    import tempfile

    import torch

    from recman_tpu_torch.data import (
        iter_criteo_chunks,
        load_criteo_tsv_native,
        synthetic_criteo_arrays,
    )
    from recman_tpu_torch.ckpt import restore_checkpoint
    from recman_tpu_torch.data.native_loader import get_lib
    from recman_tpu_torch.serving import Predictor
    from recman_tpu_torch.training import Preempted, Resilience

    card = card_line()
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="resilience_") as tmp:
        # (a) resume bit-exact
        data = synthetic_criteo_arrays(RESUME_ROWS, num_buckets=NUM_BUCKETS, seed=7)
        x, y = {k: v for k, v in data.items() if k != "y"}, data["y"]
        steps_per_epoch = RESUME_ROWS // BATCH + 1
        ref = resilient_trainer(device)
        ref.fit(x, y, resilience=Resilience(f"{tmp}/A", every_epochs=10**6, preempt_signals=()))
        t1 = resilient_trainer(device)
        save_s = []
        res = preempting(f"{tmp}/B", PREEMPT_STEP, save_s, every_steps=4, keep=2)
        try:
            t1.fit(x, y, resilience=res)
        except Preempted as e:
            log(f"resilience (a): {e}")
        else:
            check(False, "fit was not preempted")
        path, meta = res.latest()
        check(meta["step"] == PREEMPT_STEP, f"LATEST reads step {meta['step']}, not {PREEMPT_STEP}")
        ckpt_bytes = dir_bytes(path)
        del t1
        t2 = resilient_trainer(device)
        with scatter_counter() as scatters:
            reset_counts()
            t2.fit(x, y, resilience=Resilience(f"{tmp}/B", every_steps=4, keep=2))
            torch.cuda.synchronize()
            fit_counts = kernel_counts()
        resumed = 2 * steps_per_epoch - PREEMPT_STEP
        eval_batches = 2 * steps_per_epoch  # the epoch-0 and epoch-2 evals
        check_counts(fit_counts, {"K1": eval_batches, "K1 save": resumed, "K2": resumed,
                                  "K3": resumed, "K2 recompute": 0, "K4": 0, "K5": 0, "K6": 0,
                                  "K7": 0}, "resumed fit")
        check(scatters[0] == 0, f"the resumed fit reached index_add_ {scatters[0]} times")
        n_opt = states_equal(ref.state, t2.state, "resumed fit against the uninterrupted one")
        log(f"resilience (a): resumed at step {PREEMPT_STEP} of {2 * steps_per_epoch} "
            f"({RESUME_ROWS} rows, {steps_per_epoch} steps an epoch): {len(ref.state.params)} "
            f"params, {n_opt} optimizer-state tensors and step {t2.state.step} bit-equal to the "
            f"uninterrupted fit; launches {fit_counts}, index_add_ {scatters[0]}")
        del ref

        # restore, timed (page-cached files, host to card)
        final = res.latest()[0]
        restore_s = []
        for _ in range(3):
            fresh = resilient_trainer(device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh.restore(final)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
            del fresh
        states_equal(t2.state, resilient_trainer(device).restore(final).state,
                     "the final checkpoint restored")
        n_params = sum(v.numel() for v in t2.state.params.values())

        # (b) Predictor.from_checkpoint, on the card and on the CPU
        rows = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=5)
        rows.pop("y")
        want = t2.predict(rows)
        card_pred = Predictor.from_checkpoint(final, "xdeepfm", hparams=RESUME_HP,
                                              batch_size=BATCH, device=device).predict(rows)
        check(np.array_equal(card_pred, want), "Predictor.from_checkpoint on the card differs "
              f"from trainer.predict: max|dp| {float(np.abs(card_pred - want).max())}")
        cpu_rows = {k: v[:2 * BATCH] for k, v in rows.items()}
        cpu_pred = Predictor.from_checkpoint(final, "xdeepfm", hparams=RESUME_HP,
                                             batch_size=BATCH, device="cpu").predict(cpu_rows)
        dp = float(np.abs(cpu_pred - want[:2 * BATCH]).max())
        check(dp <= PRED_TOL, f"Predictor.from_checkpoint on the CPU: max|dp| {dp} > {PRED_TOL}")
        # the card's checkpoint on the CPU: params, moments and step restore
        # into a template without a generator; Trainer.restore refuses the
        # card's generator
        cpu_trainer = resilient_trainer("cpu")
        refused = None
        try:
            cpu_trainer.restore(final)
        except ValueError as e:
            refused = e
        check(refused is not None and "cuda dropout generator" in str(refused),
              f"Trainer.restore on the CPU of the card's checkpoint: {refused!r}")
        on_cpu = restore_checkpoint(final, cpu_trainer.state._replace(generator=None))
        check(on_cpu.generator is None, "a generator restored across device types")
        check(all(v.device.type == "cpu" for v in on_cpu.params.values()), "params not on the CPU")
        n_cpu = states_equal(on_cpu, t2.state, "the card's checkpoint restored on the CPU")
        log(f"resilience (b): from_checkpoint bit-equal to trainer.predict on {N_ROWS} rows on "
            f"the card; on the CPU, {2 * BATCH} rows, max|dp| {dp:.3e} (bound {PRED_TOL}); "
            f"the card's checkpoint restored on the CPU: params, {n_cpu} optimizer-state tensors "
            f"and step bit-equal; Trainer.restore refused: {refused}")
        del cpu_trainer, on_cpu
        del t2

        # (c) fit_stream on a TSV
        tsv = f"{tmp}/day.tsv"
        t0 = time.perf_counter()
        write_criteo_tsv(tsv, STREAM_ROWS, seed=11)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        get_lib()  # g++ builds native/criteo_parser.cpp on first use
        build_s = time.perf_counter() - t0
        parse_s = []
        for _ in range(3):
            t0 = time.perf_counter()
            full = load_criteo_tsv_native(tsv, num_buckets=NUM_BUCKETS)
            parse_s.append(time.perf_counter() - t0)
        parse_s = statistics.median(parse_s)
        check(len(full["y"]) == STREAM_ROWS, f"native parse read {len(full['y'])} rows")
        chunks = list(iter_criteo_chunks(tsv, NUM_BUCKETS, STREAM_CHUNK))
        check([len(c["y"]) for c in chunks] == [STREAM_CHUNK] * (STREAM_ROWS // STREAM_CHUNK),
              f"chunk rows {[len(c['y']) for c in chunks]}")
        for k, v in full.items():
            check(np.array_equal(np.concatenate([c[k] for c in chunks]), v),
                  f"chunked parse differs from the full parse in {k}")
        del chunks
        log(f"resilience (c): TSV of {STREAM_ROWS} rows ({os.path.getsize(tsv)} bytes, written "
            f"in {write_s:.2f} s) parsed natively in {parse_s:.4f} s (median of 3; the "
            f"parser's g++ build {build_s:.2f} s before), {STREAM_ROWS / parse_s:.1f} rows/s; "
            f"{STREAM_ROWS // STREAM_CHUNK} chunks of "
            f"{STREAM_CHUNK} equal to the full parse [{card}]")

        def factory():
            return iter_criteo_chunks(tsv, NUM_BUCKETS, STREAM_CHUNK)

        steps_per_chunk = STREAM_CHUNK // BATCH + 1
        steps = 2 * (STREAM_ROWS // STREAM_CHUNK) * steps_per_chunk
        ref = resilient_trainer(device)
        ref.fit_stream(factory, epochs=2, resilience=Resilience(
            f"{tmp}/C", every_epochs=10**6, preempt_signals=()))
        t1 = resilient_trainer(device)
        res = preempting(f"{tmp}/D", STREAM_PREEMPT_STEP, save_s, every_steps=4, keep=2)
        try:
            t1.fit_stream(factory, epochs=2, resilience=res)
        except Preempted as e:
            log(f"resilience (c): {e}")
        else:
            check(False, "fit_stream was not preempted")
        _, meta = res.latest()
        pos = {"epoch": 2, "chunk": 2,
               "batch": STREAM_PREEMPT_STEP - (STREAM_ROWS // STREAM_CHUNK + 2) * steps_per_chunk}
        check(meta["step"] == STREAM_PREEMPT_STEP and meta["stream"] == pos,
              f"LATEST {_json.dumps(meta)}; expected step {STREAM_PREEMPT_STEP} at {pos}")
        del t1
        t2 = resilient_trainer(device)
        with scatter_counter() as scatters:
            reset_counts()
            t2.fit_stream(factory, epochs=2,
                          resilience=Resilience(f"{tmp}/D", every_steps=4, keep=2))
            torch.cuda.synchronize()
            stream_counts = kernel_counts()
        resumed = steps - STREAM_PREEMPT_STEP
        check_counts(stream_counts, {"K1": 0, "K1 save": resumed, "K2": resumed, "K3": resumed},
                     "resumed fit_stream")
        check(scatters[0] == 0, f"the resumed fit_stream reached index_add_ {scatters[0]} times")
        n_opt = states_equal(ref.state, t2.state,
                             "resumed fit_stream against the uninterrupted one")
        streamed = t2.predict_stream(factory)
        resident = t2.predict({k: v for k, v in full.items() if k != "y"})
        check(np.array_equal(streamed, resident), "predict_stream differs from predict: max|dp| "
              f"{float(np.abs(streamed - resident).max())}")
        check(bool(np.isfinite(resident).all()), "non-finite stream predictions")
        log(f"resilience (c): fit_stream resumed at step {STREAM_PREEMPT_STEP} of {steps} "
            f"({_json.dumps(meta['stream'])}): params, {n_opt} optimizer-state tensors and step "
            f"{t2.state.step} bit-equal to the uninterrupted fit_stream; launches "
            f"{stream_counts}; predict_stream bit-equal to predict on {STREAM_ROWS} rows")
        log(f"resilience: checkpoint {ckpt_bytes} bytes on disk ({n_params} params); save "
            f"{statistics.median(save_s):.3f} s (median of {len(save_s)}: "
            f"{[round(v, 3) for v in save_s]}), restore "
            f"{statistics.median(restore_s):.3f} s (median of 3) [{card}]")
    return {"fit": fit_counts, "fit_stream": stream_counts}


@contextlib.contextmanager
def step_events():
    """A CUDA event recorded before the first and after every
    ``Trainer.fit_on_batch`` of the block, the loop of ``Trainer.fit``;
    yields the list."""
    import torch

    from recman_tpu_torch.training import Trainer

    events = []
    inner = Trainer.fit_on_batch

    def timed(self, *a, **k):
        if not events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[0].record()
        out = inner(self, *a, **k)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    Trainer.fit_on_batch = timed
    try:
        yield events
    finally:
        Trainer.fit_on_batch = inner


@contextlib.contextmanager
def lookup_spy():
    """Record which embedding lookup the block's forwards call: "packed"
    (``PackedEmbeddingLinear.apply``), "apply" (``EmbeddingLayer.apply``)
    or "apply_dict" (``EmbeddingLayer.apply_dict``); yields the set."""
    from recman_tpu_torch.layers import EmbeddingLayer, PackedEmbeddingLinear

    seen = set()
    sites = ((PackedEmbeddingLinear, "apply", "packed"), (EmbeddingLayer, "apply", "apply"),
             (EmbeddingLayer, "apply_dict", "apply_dict"))
    real = [getattr(cls, attr) for cls, attr, _ in sites]

    def spy(fn, label):
        def called(*a, **k):
            seen.add(label)
            return fn(*a, **k)
        return called

    for (cls, attr, label), fn in zip(sites, real):
        setattr(cls, attr, spy(fn, label))
    try:
        yield seen
    finally:
        for (cls, attr, _), fn in zip(sites, real):
            setattr(cls, attr, fn)


def lookup_launches(model, lookup):
    """Segment-sum launches a train step makes under ``grad_kernel("segmat")``
    with per-table storage, from the schema and the lookup the model's
    forward calls (``lookup_spy``). A group of same-shape tables shares one
    K3 launch; a table alone runs K6.
    - "packed": the packable tables grouped by (table shape, id shape);
    - "apply": the plain sparse feats' tables grouped by (table shape, id
      shape), then one K6 per other feature (multi-valued, value-scaled or
      sequence), and all that twice with bias tables;
    - "apply_dict": one K6 per feature (the sequence family's history into
      item_id's table among them), twice with bias tables."""
    import collections

    from recman_tpu_torch.features import (
        MultiValCsvFeat, MultiValSparseFeat, SparseFeat, SparseValueFeat,
    )

    def count(groups, alone=0):
        return {"K6": alone + sum(n == 1 for n in groups.values()),
                "K3": sum(n > 1 for n in groups.values())}

    if lookup == "packed":
        return count(collections.Counter(
            (f.feat_size, isinstance(f, (MultiValCsvFeat, MultiValSparseFeat)))
            for f in model.packed.packable))
    emb = model.embeddings
    times = 2 if emb.use_bias else 1
    if lookup == "apply_dict":
        return {"K6": len(emb.feats) * times, "K3": 0}
    check(lookup == "apply", f"unknown lookup {lookup!r}")
    plain = [f for f in emb.feats if isinstance(f, SparseFeat) and not isinstance(f, SparseValueFeat)]
    one = count(collections.Counter(f.feat_size for f in plain), len(emb.feats) - len(plain))
    return {k: n * times for k, n in one.items()}


def parallel_model():
    from recman_tpu_torch.data import create_criteo_features
    from recman_tpu_torch.models import XDeepFM

    return XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), PARALLEL_HP)


def parallel_data():
    from recman_tpu_torch.data import synthetic_criteo_arrays

    data = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    return {k: v for k, v in data.items() if k != "y"}, data["y"]


def parallel_run(trainer, data, idx, layout):
    """PARALLEL_STEPS checked ``fit_on_batch`` steps from 0 launches (the
    losses, the launches), then PARALLEL_TIMED timed ones (``timed_steps``:
    device ms per step, wall ms, their launches)."""
    import torch

    reset_counts()
    losses = [trainer.fit_on_batch(data, idx[i], layout) for i in range(PARALLEL_STEPS)]
    torch.cuda.synchronize()
    counts = kernel_counts()
    losses = [float(v) for v in losses]
    step_ms, wall, _, timed = timed_steps(trainer, data, idx, layout, PARALLEL_TIMED)
    return {"losses": losses, "counts": counts, "step_ms": step_ms, "wall_ms": wall,
            "timed_counts": timed}


def parallel_rank(directory, device):
    """One rank of phase_parallel's two-rank world (Gloo; on one card both
    ranks use it): (b) explicit DP at (2, 1), (c) the row-sharded route at
    (1, 2) with each exchange. Returns numbers and digests for the parent."""
    import hashlib

    import torch

    from recman_tpu_torch.parallel import ShardedTrainer, make_mesh
    from recman_tpu_torch.parallel import collectives
    from recman_tpu_torch.parallel.distributed import rank_device
    from recman_tpu_torch.parallel.train_explicit import dp_grads, rank_batch
    from recman_tpu_torch.parallel.train_pjit import shard_state
    from recman_tpu_torch.serving import Predictor

    ref = torch.load(f"{directory}/reference.pt", weights_only=True)
    device = rank_device(device)
    model = parallel_model()
    x, y = parallel_data()
    out = {}

    def trainer(mesh, **kw):
        t = ShardedTrainer(model, PARALLEL_HP, batch_size=BATCH, mesh=mesh, device=device, **kw)
        t.state = shard_state(t.optimizer, ref["params"], mesh, t.specs, 0, device)
        return t

    # (b) explicit DP, 4096 rows a rank
    mesh = make_mesh(data=2, model=1)
    t = trainer(mesh)
    data, layout = t._to_device(x, y)
    idx = torch.as_tensor(t._batch_index_matrix(N_ROWS, shuffle_seed=0), device=device)
    d, lb = mesh.data_index, BATCH // 2
    ub, w = rank_batch(mesh, data, idx[0], layout)
    card = [z[d * lb:(d + 1) * lb] for z in ref["record"]]
    grads, _ = activation_recorded_grads(
        model, t.state.params, ub, w, seq_sites(model), card=card,
        grad_fn=lambda p, b, ww: dp_grads(model, mesh, p, b, ww, None)[1])
    out["grad_rel"] = max((rel_err(ref["grads"][k], grads[k].cpu()), k) for k in grads)
    out["dp"] = parallel_run(t, data, idx, layout)
    out["dp"]["explicit"] = t._explicit_dp
    preds = t.predict(x)
    plain = Predictor(model, t.state.params, batch_size=BATCH, device=device).predict(x)
    out["dp"]["pred_err"] = float(np.abs(preds - plain).max())
    del t, data, grads
    torch.cuda.empty_cache()

    # (c) the row-sharded route, each exchange
    mesh = make_mesh(data=1, model=2)
    for exchange in ("psum", "dedup"):
        t = trainer(mesh, embedding_exchange=exchange)
        data, layout = t._to_device(x, y)
        run = {"explicit": t._explicit_dp,
               "sharded": sorted(k for k, s in t.specs.items() if s),
               "blocks": {k: tuple(v.shape) for k, v in t.state.params.items() if t.specs[k]}}
        collectives.reset_traffic()
        t.fit_on_batch(data, idx[0], layout)  # sizes the capacity, checks the first batch
        collectives.reset_traffic()
        t.fit_on_batch(data, idx[1], layout)
        run["traffic"] = {f"{o}/{a}/{g}": b for (o, a, g), b in collectives.TRAFFIC.items()}
        run["capacity"] = t.dedup_capacity
        run["overflow"] = [t.dedup_overflow_report(data, idx[i], layout) if exchange == "dedup"
                           else {} for i in range(PARALLEL_STEPS)]
        t.state = shard_state(t.optimizer, ref["params"], mesh, t.specs, 0, device)
        run.update(parallel_run(t, data, idx, layout))
        run["dense"] = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                        for k, v in t.state.params.items() if not t.specs[k]}
        out[exchange] = run
        del t, data
        torch.cuda.empty_cache()

    # (d) tensor-parallel DNN at (1, 2), psum
    t = trainer(mesh, tp_dense_threshold=PARALLEL_TP)
    data, layout = t._to_device(x, y)
    run = {"explicit": t._explicit_dp,
           "blocks": {k: tuple(v.shape) for k, v in t.state.params.items() if t.specs[k]},
           "specs": {k: s for k, s in t.specs.items() if "dnn" in k and s}}
    collectives.reset_traffic()
    t.fit_on_batch(data, idx[0], layout)
    run["traffic"] = {f"{o}/{a}/{g}": b for (o, a, g), b in collectives.TRAFFIC.items()}
    t.state = shard_state(t.optimizer, ref["params"], mesh, t.specs, 0, device)
    run.update(parallel_run(t, data, idx, layout))
    run["replicated"] = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
                         for k, v in t.state.params.items() if not t.specs[k]}
    out["tp"] = run
    del t, data
    torch.cuda.empty_cache()
    out["resume"] = parallel_resume(mesh, device, trainer)
    out["stream"] = parallel_stream(mesh, device, trainer, x, y)
    out["dien"] = parallel_dien(device)
    out["qr"] = parallel_qr(mesh, device)
    return out


def traced_fit_stream(trainer, chunks):
    """``fit_stream(chunks, epochs=1)`` with the loss of every step read
    back: the trace."""
    losses = []
    inner = trainer.fit_on_batch
    trainer.fit_on_batch = lambda *a: losses.append(inner(*a)) or losses[-1]
    try:
        trainer.fit_stream(chunks, epochs=1)
    finally:
        del trainer.fit_on_batch
    return [float(v) for v in losses]


def parallel_chunks(x, y):
    """(f)'s chunk factory: PARALLEL_STREAM_CHUNKS chunks of
    PARALLEL_STREAM_CHUNK rows."""
    def chunks():
        for c in range(PARALLEL_STREAM_CHUNKS):
            rows = slice(c * PARALLEL_STREAM_CHUNK, (c + 1) * PARALLEL_STREAM_CHUNK)
            yield {**{k: v[rows] for k, v in x.items()}, "y": y[rows]}
    return chunks


def parallel_resume(mesh, device, trainer):
    """(e) at (1, 2), psum: a resilient fit of RESUME_ROWS uninterrupted;
    one that a real SIGTERM to rank 1 alone preempts at PREEMPT_STEP; its
    resume by a fresh trainer. Returns the digests, the step each rank
    checkpointed at, the checkpoint's bytes and the saves' seconds."""
    import hashlib
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from recman_tpu_torch.ckpt.checkpoint import _flatten
    from recman_tpu_torch.data import synthetic_criteo_arrays
    from recman_tpu_torch.ops.embedding import grad_kernel
    from recman_tpu_torch.parallel import MeshResilience
    from recman_tpu_torch.parallel.checkpoint import barrier
    from recman_tpu_torch.training import Preempted, Resilience

    def digest(t):
        leaves = {f"param/{k}": v for k, v in t.state.params.items()}
        leaves.update({"/".join(map(str, p)): v for p, v in _flatten(t.state.opt_state)
                       if isinstance(v, torch.Tensor)})
        out = {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest() for k, v in leaves.items()}
        out["step"] = int(t.state.step)
        out["generator"] = hashlib.sha256(t.state.generator.get_state().cpu().numpy()
                                          .tobytes()).hexdigest()
        return out

    data = synthetic_criteo_arrays(RESUME_ROWS, num_buckets=NUM_BUCKETS, seed=7)
    x, y = {k: v for k, v in data.items() if k != "y"}, data["y"]
    tmp = os.path.abspath(os.path.join("build", f"parallel_resume_{os.getppid()}"))
    out = {}
    # "segmat": the linear tower's psum gathers take K6, so that no
    # index_add_ reorders a sum between two runs of the same steps
    with grad_kernel("segmat"):
        ref = trainer(mesh, epoch=PARALLEL_RESUME_EPOCHS)
        ref.fit(x, y, resilience=Resilience(f"{tmp}/A", every_epochs=10**6, preempt_signals=()))
        out["ref"] = digest(ref)
        del ref
        save_s = []
        res = preempting(f"{tmp}/B", PREEMPT_STEP if dist.get_rank() == 1 else None, save_s,
                         base=MeshResilience)
        try:
            trainer(mesh, epoch=PARALLEL_RESUME_EPOCHS).fit(x, y, resilience=res)
            out["preempted"] = None
        except Preempted as e:
            out["preempted"] = str(e)
        out["saved_step"], out["save_s"] = res._last_saved_step, save_s
        path, meta = res.latest()
        out["latest_step"], out["ckpt_bytes"] = meta["step"], dir_bytes(path)
        t2 = trainer(mesh, epoch=PARALLEL_RESUME_EPOCHS)
        reset_counts()
        with scatter_counter() as scatters:
            t2.fit(x, y, resilience=Resilience(f"{tmp}/B", preempt_signals=()))
        torch.cuda.synchronize()
    out["scatters"] = scatters[0]
    out["counts"] = kernel_counts()
    out["resumed"] = digest(t2)
    del t2
    torch.cuda.empty_cache()
    barrier(mesh, device)
    if dist.get_rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def parallel_stream(mesh, device, trainer, x, y):
    """(f) at (1, 2), psum: fit_stream's trace over parallel_chunks, and
    predict_stream against predict."""
    import torch

    t = trainer(mesh)
    reset_counts()
    trace = traced_fit_stream(t, parallel_chunks(x, y))
    torch.cuda.synchronize()
    counts = kernel_counts()
    rows = PARALLEL_STREAM_CHUNKS * PARALLEL_STREAM_CHUNK
    xs = {k: v[:rows] for k, v in x.items()}
    streamed = t.predict_stream(parallel_chunks(x, y))
    whole = t.predict(xs)
    out = {"losses": trace, "counts": counts, "pred_equal": bool(np.array_equal(streamed, whole)),
           "pred_rows": int(streamed.shape[0])}
    del t
    torch.cuda.empty_cache()
    return out


def parallel_dien(device):
    """(g) DIEN with aux_loss_weight 0.5 and Dice at (2, 1) on the sequence
    phase's ML-100K rows, from the seed-2019 params: the step-1 gradients
    summed over the data group, and as a control the same gradients with
    Dice's moments taken on each rank's own rows (the route before Dice's
    moments were taken over the data group); then PARALLEL_STEPS checked
    steps under "segmat" (the row-sharded route, DIEN's own loss; K6 for
    each of the 7 lookups a step) and the moments calibrate writes."""
    import torch

    from recman_tpu_torch.models import model_class
    from recman_tpu_torch.ops.embedding import grad_kernel
    from recman_tpu_torch.parallel import ShardedTrainer, make_mesh, shard_init_state
    from recman_tpu_torch.parallel.collectives import all_reduce
    from recman_tpu_torch.parallel.train_explicit import DataSplit, rank_batch
    from recman_tpu_torch.parallel.train_pjit import sharded_forward, sharded_grads
    from recman_tpu_torch.training import batch_indices
    from recman_tpu_torch.training.train_step import value_and_grads
    from recman_tpu_torch.utils import JaxKey

    mesh = make_mesh(data=2, model=1)
    (train, _, _), fs, (x_train, _, _) = ml_seq_tables()
    model = model_class("dien")(fs, PARALLEL_DIEN_HP)
    t = ShardedTrainer(model, PARALLEL_DIEN_HP, batch_size=SEQ_BATCH, mesh=mesh, device=device)
    t.state = shard_init_state(model, t.optimizer, JaxKey(2019), mesh, device=device)
    n = len(train["label"])
    data, layout = t._to_device(x_train, train["label"].astype(np.float32))
    idx = torch.as_tensor(batch_indices(n, SEQ_BATCH, shuffle_seed=ML_SEED), device=device)
    ub, w = rank_batch(mesh, data, idx[0], layout)
    params = t.state.params

    def per_rank_moments(p):
        with sharded_forward(mesh, p, t.specs, moments=False):
            return model.rank_loss(p, ub, w, DataSplit(mesh), training=True)

    with grad_kernel("segmat"):
        grads = sharded_grads(model, mesh, t.specs, params, ub, w, None)[1]
        control = value_and_grads(per_rank_moments, params)[1]
        with torch.no_grad():
            control = {k: all_reduce(g, mesh, "data", "grad") for k, g in control.items()}
    out = {"grads": {k: g.cpu() for k, g in grads.items()},
           "control": {k: g.cpu() for k, g in control.items()}}
    del grads, control
    reset_counts()
    with grad_kernel("segmat"):  # the sequence phase's route: K6 for every lookup
        losses = [t.fit_on_batch(data, idx[i], layout) for i in range(PARALLEL_STEPS)]
    torch.cuda.synchronize()
    out.update({"explicit": t._explicit_dp, "counts": kernel_counts(),
                "losses": [float(v) for v in losses]})
    out["calibrated"] = t.calibrate({k: v[:8192] for k, v in x_train.items()})
    out["moments"] = {k: v.cpu() for k, v in t.state.params.items() if "_dice_" in k}
    del t, data
    torch.cuda.empty_cache()
    return out


def parallel_qr_setup():
    """(h)'s schema and rows: QR (q QR_COLLISIONS) on all 26 hashed fields
    of the bench model, as the export phase's (c)."""
    from recman_tpu_torch.data import CAT_NAMES, create_criteo_features, synthetic_criteo_arrays

    qfs = create_criteo_features(num_buckets=NUM_BUCKETS)
    for name in CAT_NAMES:
        qfs[name].qr_collisions = QR_COLLISIONS
    n_rows = (PARALLEL_STEPS + 1) * BATCH
    qdata = synthetic_criteo_arrays(n_rows, num_buckets=NUM_BUCKETS, seed=11)
    return qfs, {k: v for k, v in qdata.items() if k != "y"}, qdata["y"], n_rows


def parallel_qr(mesh, device):
    """(h) QR with Lamb at (1, 2): the quotient tables and linear_w
    row-sharded, PARALLEL_STEPS checked steps from the seed-2019 params
    under "segmat", the export phase's QR route (K6 for every lookup's
    backward: the 26 quotient blocks', the 26 remainder tables' and the
    one psum exchange of the linear tower's)."""
    import torch

    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops.embedding import grad_kernel
    from recman_tpu_torch.parallel import ShardedTrainer, shard_init_state
    from recman_tpu_torch.utils import JaxKey

    qfs, x, y, n_rows = parallel_qr_setup()
    model = XDeepFM(qfs, PARALLEL_QR_HP)
    t = ShardedTrainer(model, PARALLEL_QR_HP, batch_size=BATCH, mesh=mesh, device=device,
                       row_shard_threshold=PARALLEL_QR_THRESHOLD)
    t.state = shard_init_state(model, t.optimizer, JaxKey(2019), mesh, PARALLEL_QR_THRESHOLD,
                               device=device)
    data, layout = t._to_device(x, y)
    idx = torch.as_tensor(t._batch_index_matrix(n_rows, shuffle_seed=3), device=device)
    reset_counts()
    with grad_kernel("segmat"), scatter_counter() as scatters:
        losses = [t.fit_on_batch(data, idx[i], layout) for i in range(PARALLEL_STEPS)]
    torch.cuda.synchronize()
    out = {"counts": kernel_counts(), "losses": [float(v) for v in losses],
           "scatters": scatters[0],
           "sharded": sorted(k for k, s in t.specs.items() if s),
           "blocks": {k: tuple(v.shape) for k, v in t.state.params.items() if t.specs[k]}}
    del t, data
    torch.cuda.empty_cache()
    return out


def phase_parallel(device):
    """parallel/ at the bench model's widths through ShardedTrainer: (a) one
    rank on NCCL (the explicit DP route) against the plain Trainer from the
    same params and index rows; (b) two ranks on this card over Gloo,
    explicit DP at (2, 1); (c) two ranks, the row-sharded route at (1, 2)
    with the psum and the dedup exchange; (d) the tensor-parallel DNN at
    (1, 2); (e) a resilient fit at (1, 2) preempted by a real SIGTERM to
    rank 1 alone and resumed; (f) fit_stream and predict_stream at (1, 2)
    against the plain Trainer's; (g) DIEN with its auxiliary loss and Dice
    at (2, 1) on ML-100K; (h) QR with Lamb at (1, 2). Returns the launches
    of each run's checked steps (the resumed fit's for (e)), per kernel."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from recman_tpu_torch.parallel import ShardedTrainer
    from recman_tpu_torch.parallel.launch import run_world
    from recman_tpu_torch.parallel.traffic import collective_traffic_model
    from recman_tpu_torch.training import Trainer, gather_batch, init_state, unpack_batch
    from recman_tpu_torch.utils import JaxKey

    card = card_line()
    model = parallel_model()
    x, y = parallel_data()
    plain = Trainer(model, PARALLEL_HP, batch_size=BATCH, device=device)
    plain.state = init_state(model, plain.optimizer, JaxKey(2019), device=device)
    params0 = {k: v.cpu() for k, v in plain.state.params.items()}
    data, layout = plain._to_device(x, y)
    idx = torch.as_tensor(plain._batch_index_matrix(N_ROWS, shuffle_seed=0), device=device)
    batch, w = gather_batch(data, idx[0])
    grads, record = activation_recorded_grads(model, plain.state.params, unpack_batch(batch, layout),
                                              w, seq_sites(model))
    reset_counts()
    trace = np.asarray([float(plain.fit_on_batch(data, idx[i], layout))
                        for i in range(PARALLEL_STEPS)])

    # (a) one rank, NCCL: make_mesh starts the one-rank group
    t = ShardedTrainer(model, PARALLEL_HP, batch_size=BATCH, device=device)
    try:
        check(dist.get_backend() == "nccl" and t._explicit_dp, "(a) is not one NCCL rank on DP")
        t.state = init_state(model, t.optimizer, JaxKey(2019), device=device)
        a = parallel_run(t, data, idx, layout)
    finally:
        dist.destroy_process_group()
    rel = float(np.abs(np.asarray(a["losses"]) - trace).max() / np.abs(trace).max())
    check(rel <= PARALLEL_ONE_RANK_TOL, f"(a) trace {a['losses']} vs the plain {trace.tolist()}")
    once = {"K1 save": PARALLEL_STEPS, "K2": PARALLEL_STEPS, "K3": PARALLEL_STEPS}
    check_counts(a["counts"], once, "(a) one rank")
    log(f"parallel (a) one NCCL rank, DP: trace {a['losses']} vs plain {trace.tolist()} (max rel "
        f"{rel:.3e}); step {a['step_ms']:.3f} ms device, {a['wall_ms']:.3f} ms wall "
        f"[{card}]; launches {a['counts']}")
    del t, plain, data, batch, w
    torch.cuda.empty_cache()
    plain_refs = parallel_plain_refs(model, params0, x, y, device)

    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="parallel_") as tmp:
        torch.save({"params": params0, "grads": {k: v.cpu() for k, v in grads.items()},
                    "record": record}, f"{tmp}/reference.pt")
        t0 = time.perf_counter()
        ranks = run_world(parallel_rank, 2, backend="gloo", device=device.type,
                          args=(tmp, device.type), timeout_s=PARALLEL_WORLD_S, threads=4)
        log(f"parallel two-rank world {time.perf_counter() - t0:.1f} s")

    def traced(run, what):
        got = np.asarray(run["losses"])
        err = float(np.abs(got - np.asarray(a["losses"])).max())
        check(np.allclose(got, a["losses"], rtol=PARALLEL_TRACE_RTOL, atol=PARALLEL_TRACE_ATOL),
              f"{what} trace {got.tolist()} vs (a) {a['losses']}")
        return err

    launches = {"a": a["counts"]}
    for r, out in enumerate(ranks):
        dp = out["dp"]
        check(dp["explicit"], "(b) did not take the explicit DP route")
        check(out["grad_rel"][0] <= PARALLEL_GRAD_TOL,
              f"(b) rank {r} step-1 grad {out['grad_rel']} over {PARALLEL_GRAD_TOL} of max|ref|")
        check_counts(dp["counts"], once, f"(b) rank {r}")
        check(dp["pred_err"] <= PARALLEL_PRED_TOL, f"(b) rank {r} predict {dp['pred_err']}")
        err = traced(dp, f"(b) rank {r}")
        log(f"parallel (b) rank {r}, DP (2, 1) over Gloo: trace {dp['losses']} (max|d| from (a) "
            f"{err:.3e}); step-1 grads {out['grad_rel'][0]:.3e} of max|ref| ({out['grad_rel'][1]}); "
            f"predict max|d| {dp['pred_err']:.3e}; step {dp['step_ms']:.3f} ms device, "
            f"{dp['wall_ms']:.3f} ms wall [{card}]; launches {dp['counts']}")
        for exchange in ("psum", "dedup"):
            run = out[exchange]
            check(not run["explicit"], f"(c) {exchange} took the DP route")
            # psum's local gathers take the lookups' backward: one K3 over
            # the 26 same-shape blocks a step; dedup's take autograd's
            k3 = PARALLEL_STEPS if exchange == "psum" else 0
            check_counts(run["counts"], {"K1 save": PARALLEL_STEPS, "K2": PARALLEL_STEPS, "K3": k3,
                                         "K6": 0, "K7": 0}, f"(c) {exchange} rank {r}")
            check(run["blocks"]["linear_w"] == (-(-model.linear.total_size // 2),)
                  and run["blocks"]["C1_feat_embed"] == (-(-(NUM_BUCKETS + 1) // 2),
                                                         HPARAMS["embedding_size"]),
                  f"(c) blocks {run['blocks']}")
            check(all(not any(o.values()) for o in run["overflow"]),
                  f"(c) dedup overflow {run['overflow']}")
            err = traced(run, f"(c) {exchange} rank {r}")
            kw = dict(n_tables=26, vocab=NUM_BUCKETS + 2, k=HPARAMS["embedding_size"],
                      batch_local=BATCH, data_shards=1, model_shards=2)
            tr = run["traffic"]
            if exchange == "psum":
                model_b = collective_traffic_model(**kw)["model_axis"]["psum_bytes"]
                got_b = tr["all_reduce/model/table"]
            else:
                model_b = collective_traffic_model(capacity=min(run["capacity"], BATCH), **kw)[
                    "model_axis"]["dedup_bytes"]
                got_b = tr["all_gather/model/table"] + tr["reduce_scatter/model/table"]
            check(got_b == model_b, f"(c) {exchange} counted {got_b} B, the model {model_b}")
            log(f"parallel (c) rank {r}, row-sharded (1, 2), {exchange}: trace {run['losses']} "
                f"(max|d| from (a) {err:.3e}); capacity {run['capacity']}; table exchange "
                f"{got_b} B a step counted = {model_b} B collective_traffic_model; a step's "
                f"bytes {tr}; step {run['step_ms']:.3f} ms device, {run['wall_ms']:.3f} ms wall "
                f"[{card}]; launches {run['counts']}")
            launches[f"c_{exchange}_rank{r}"] = run["counts"]
        launches[f"b_rank{r}"] = dp["counts"]
    for exchange in ("psum", "dedup"):
        check(ranks[0][exchange]["dense"] == ranks[1][exchange]["dense"],
              f"(c) {exchange}: dense params differ between the model ranks")
    log("parallel (c): dense params bit-equal across the two model ranks, both exchanges; two "
        f"ranks share one card, so no time here is a scaling figure [{card}]")
    launches.update(parallel_checks(ranks, a, plain_refs, model, card, traced))
    return launches


def parallel_plain_refs(model, params0, x, y, device):
    """The plain Trainer's runs on the card that (f), (g) and (h) are held
    to: fit_stream's trace from params0 over parallel_chunks; DIEN's
    PARALLEL_STEPS-step trace and calibrated moments; QR with Lamb's
    trace."""
    import torch

    from recman_tpu_torch.models import XDeepFM, model_class
    from recman_tpu_torch.ops.embedding import grad_kernel
    from recman_tpu_torch.training import Trainer, TrainState, batch_indices, init_state
    from recman_tpu_torch.training.train_step import gather_batch, loss_and_grads, unpack_batch
    from recman_tpu_torch.utils import JaxKey

    out = {}
    t = Trainer(model, PARALLEL_HP, batch_size=BATCH, device=device)
    params = {k: v.to(device) for k, v in params0.items()}
    t.state = TrainState(params, t.optimizer.init(params), 0, None)
    out["stream"] = traced_fit_stream(t, parallel_chunks(x, y))
    del t, params
    torch.cuda.empty_cache()

    (train, _, _), fs, (x_train, _, _) = ml_seq_tables()
    dien = model_class("dien")(fs, PARALLEL_DIEN_HP)
    t = Trainer(dien, PARALLEL_DIEN_HP, batch_size=SEQ_BATCH, device=device)
    t.state = init_state(dien, t.optimizer, JaxKey(2019), device=device)
    data, layout = t._to_device(x_train, train["label"].astype(np.float32))
    idx = torch.as_tensor(batch_indices(len(train["label"]), SEQ_BATCH, shuffle_seed=ML_SEED),
                          device=device)
    batch, w = gather_batch(data, idx[0])
    with grad_kernel("segmat"):
        grads = loss_and_grads(dien, t.state.params, unpack_batch(batch, layout), w)[1]
        out["dien_grads"] = {k: g.cpu() for k, g in grads.items()}
        del grads
        out["dien"] = [float(t.fit_on_batch(data, idx[i], layout)) for i in range(PARALLEL_STEPS)]
    t.calibrate({k: v[:8192] for k, v in x_train.items()})
    out["dien_moments"] = {k: v.cpu() for k, v in t.state.params.items() if "_dice_" in k}
    del t, data

    qfs, qx, qy, n_rows = parallel_qr_setup()
    qr = XDeepFM(qfs, PARALLEL_QR_HP)
    t = Trainer(qr, PARALLEL_QR_HP, batch_size=BATCH, device=device)
    t.state = init_state(qr, t.optimizer, JaxKey(2019), device=device)
    data, layout = t._to_device(qx, qy)
    idx = torch.as_tensor(t._batch_index_matrix(n_rows, shuffle_seed=3), device=device)
    with grad_kernel("segmat"):
        out["qr"] = [float(t.fit_on_batch(data, idx[i], layout)) for i in range(PARALLEL_STEPS)]
    del t, data
    torch.cuda.empty_cache()
    return out


def parallel_checks(ranks, a, plain, model, card, traced):
    """The checks and log lines of (d)-(h); returns their launches by run."""
    launches = {}
    tp_shapes = {"dnn_layer_0_weights": (model.dnn.input_dim, HPARAMS["deep_hidden_units"][0] // 2),
                 "dnn_layer_1_weights": (HPARAMS["deep_hidden_units"][0] // 2,
                                         HPARAMS["deep_hidden_units"][1])}
    for r, out in enumerate(ranks):
        run = out["tp"]
        check(not run["explicit"], "(d) took the DP route")
        check({k: run["blocks"][k] for k in tp_shapes} == tp_shapes,
              f"(d) blocks {run['blocks']}, expected {tp_shapes}")
        check(run["specs"] == {"dnn_layer_0_weights": (None, "model"),
                               "dnn_layer_1_weights": ("model", None)}, f"(d) specs {run['specs']}")
        check_counts(run["counts"], {"K1 save": PARALLEL_STEPS, "K2": PARALLEL_STEPS,
                                     "K3": PARALLEL_STEPS}, f"(d) rank {r}")
        err = traced(run, f"(d) TP rank {r}")
        log(f"parallel (d) rank {r}, tensor-parallel DNN at (1, 2), psum, tp_dense_threshold "
            f"{PARALLEL_TP}: blocks {tp_shapes}; trace {run['losses']} (max|d| from (a) "
            f"{err:.3e}); step {run['step_ms']:.3f} ms device, {run['wall_ms']:.3f} ms wall; a "
            f"step's bytes {run['traffic']} [{card}]; launches {run['counts']}")
        launches[f"d_rank{r}"] = run["counts"]

        res = out["resume"]
        check(res["preempted"] is not None and res["saved_step"] == PREEMPT_STEP
              and res["latest_step"] == PREEMPT_STEP,
              f"(e) rank {r}: preempted {res['preempted']}, checkpointed at "
              f"{res['saved_step']}, LATEST {res['latest_step']}")
        bad = [k for k, v in res["ref"].items() if res["resumed"].get(k) != v]
        check(not bad and set(res["resumed"]) == set(res["ref"]),
              f"(e) rank {r}: the resumed run differs from the uninterrupted one in {bad[:5]}")
        check(res["scatters"] == 0, f"(e) rank {r}: index_add_ reached {res['scatters']} times")
        log(f"parallel (e) rank {r}, resilient fit at (1, 2), a real SIGTERM to rank 1 alone at "
            f"step {PREEMPT_STEP}: '{res['preempted']}'; checkpointed at step {res['saved_step']}; "
            f"resumed by a fresh trainer, {len(res['ref']) - 2} params and optimizer-state "
            f"tensors, the step and the generator equal to an uninterrupted run; checkpoint "
            f"{res['ckpt_bytes']} B, saves {[round(v, 3) for v in res['save_s']]} s [{card}]; "
            f"resumed launches {res['counts']}, index_add_ 0 (under segmat)")
        launches[f"e_rank{r}"] = res["counts"]

        st = out["stream"]
        got, want = np.asarray(st["losses"]), np.asarray(plain["stream"])
        check(got.shape == want.shape and np.allclose(got, want, rtol=PARALLEL_TRACE_RTOL,
                                                      atol=PARALLEL_TRACE_ATOL),
              f"(f) rank {r} fit_stream trace {got.tolist()} vs plain {want.tolist()}")
        check(st["pred_equal"] and st["pred_rows"] == PARALLEL_STREAM_CHUNKS * PARALLEL_STREAM_CHUNK,
              f"(f) rank {r}: predict_stream differs from predict")
        steps = len(st["losses"])
        check_counts(st["counts"], {"K1 save": steps, "K2": steps, "K3": steps}, f"(f) rank {r}")
        log(f"parallel (f) rank {r}, fit_stream at (1, 2) over {PARALLEL_STREAM_CHUNKS} chunks of "
            f"{PARALLEL_STREAM_CHUNK} rows: trace max|d| from the plain Trainer's fit_stream "
            f"{float(np.abs(got - want).max()):.3e}; predict_stream equal to predict on "
            f"{st['pred_rows']} rows [{card}]; launches {st['counts']}")
        launches[f"f_rank{r}"] = st["counts"]

        dn = out["dien"]
        got, want = np.asarray(dn["losses"]), np.asarray(plain["dien"])
        check(not dn["explicit"], "(g) DIEN took the explicit DP route")
        check(np.allclose(got, want, rtol=PARALLEL_TRACE_RTOL, atol=PARALLEL_TRACE_ATOL),
              f"(g) rank {r} DIEN trace {got.tolist()} vs plain {want.tolist()}")
        m_rel = max(rel_err(v, dn["moments"][k]) for k, v in plain["dien_moments"].items())
        check(dn["calibrated"] and m_rel <= SEQ_MOMENT_TOL,
              f"(g) rank {r}: calibrated {dn['calibrated']}, moments {m_rel} of max|ref|")
        g_rel = max((rel_err(v, dn["grads"][k]), k) for k, v in plain["dien_grads"].items())
        c_rel = max((rel_err(v, dn["control"][k]), k) for k, v in plain["dien_grads"].items())
        check(g_rel[0] <= PARALLEL_GRAD_TOL,
              f"(g) rank {r}: step-1 gradients {g_rel[0]:.3e} of max|ref| ({g_rel[1]}) from the "
              f"plain Trainer's")
        check(c_rel[0] > PARALLEL_GRAD_TOL,
              f"(g) rank {r}: with Dice's moments per rank the step-1 gradients are within "
              f"{c_rel[0]:.3e} of the plain Trainer's: this check cannot see that fault")
        check_counts(dn["counts"], {"K6": 7 * PARALLEL_STEPS, "K3": 0}, f"(g) rank {r}")
        log(f"parallel (g) rank {r}, DIEN (aux 0.5, Dice) at (2, 1), row-sharded route: step-1 "
            f"gradients {g_rel[0]:.3e} of max|ref| ({g_rel[1]}) from the plain Trainer's, with "
            f"Dice's moments per rank {c_rel[0]:.3e} ({c_rel[1]}); trace {dn['losses']} (max|d| "
            f"from the plain Trainer {float(np.abs(got - want).max()):.3e}); calibrated moments "
            f"{m_rel:.3e} of max|ref| [{card}]; launches {dn['counts']}")
        launches[f"g_rank{r}"] = dn["counts"]

        q = out["qr"]
        got, want = np.asarray(q["losses"]), np.asarray(plain["qr"])
        check(any(k.endswith("_feat_embed_q") for k in q["sharded"]),
              f"(h) no quotient table sharded: {q['sharded']}")
        check(np.allclose(got, want, rtol=PARALLEL_TRACE_RTOL, atol=PARALLEL_TRACE_ATOL),
              f"(h) rank {r} QR lamb trace {got.tolist()} vs plain {want.tolist()}")
        check_counts(q["counts"], {"K6": PARALLEL_QR_K6 * PARALLEL_STEPS, "K3": 0,
                                   "K1 save": PARALLEL_STEPS, "K2": PARALLEL_STEPS},
                     f"(h) rank {r}")
        check(q["scatters"] == 0, f"(h) rank {r}: index_add_ reached {q['scatters']} times")
        log(f"parallel (h) rank {r}, QR (q {QR_COLLISIONS}) with lamb at (1, 2), "
            f"{len(q['sharded'])} leaves row-sharded (C1's quotient block "
            f"{q['blocks'].get('C1_feat_embed_q')}): trace {q['losses']} (max|d| from the plain "
            f"Trainer {float(np.abs(got - want).max()):.3e}) under segmat, index_add_ 0 [{card}]; "
            f"launches {q['counts']}")
        launches[f"h_rank{r}"] = q["counts"]
    check(ranks[0]["tp"]["replicated"] == ranks[1]["tp"]["replicated"],
          "(d): replicated params differ between the model ranks")
    log(f"parallel (d): every replicated param bit-equal across the two ranks [{card}]")
    return launches


def phase_zoo(device):
    """The zoo outside the sequence family: (a) the sixteen runs of the
    ML-100K quality protocol through ``examples.model_zoo_ml.run_model``
    under "segmat", each in its band, with its launches; (c) one of them
    saved and served by ``Predictor.from_checkpoint``, equal to its
    trainer's predictions; (b) dcn_paper_criteo: serving, step-1 gradients
    and a 4-step trace against the CPU, 32 timed stacked steps, a 1-epoch
    fit. Returns the launches of (a) and (b)."""
    import tempfile

    import torch

    from recman_tpu_torch.data import (
        create_criteo_features, get_ml_dataset, synthetic_criteo_arrays,
    )
    from recman_tpu_torch.examples.model_zoo_ml import RANDOM_SEED, run_model
    from recman_tpu_torch.models import DCN
    from recman_tpu_torch.ops.embedding import grad_kernel
    from recman_tpu_torch.serving import Predictor
    from recman_tpu_torch.training import (
        LogLoss, StreamingAUC, Trainer, TrainState, batch_indices, create_optimizer,
        gather_batch, make_train_step_stacked, pack_dataset, stack_table_params, unpack_batch,
    )

    card = card_line()
    # (a) ML-100K, the reference's protocol, counts from 0 around each run
    t0 = time.perf_counter()
    train, valid, test, domains = get_ml_dataset(frac=0.5, random_seed=RANDOM_SEED)
    steps = len(train["label"]) // 128 + 1
    zoo_counts, rows = {}, {}
    for label, (ref_ll, ref_auc) in ZOO_ROWS.items():
        name, hparams = ZOO_RUNS.get(label, (label, None))
        # numpy's global generator draws the epoch's shuffle seed (the
        # reference's quirk): seeded as the anchor seeds it, so a run repeats
        np.random.seed(RANDOM_SEED)
        reset_counts()
        t1 = time.perf_counter()
        with grad_kernel("segmat"), scatter_counter() as scatters, step_events() as events, \
                lookup_spy() as lookups:
            trainer, (logloss, auc) = run_model(name, hparams=hparams, device=device)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        counts = kernel_counts()
        check(trainer.device == device and all(v.is_cuda for v in trainer.params.values()),
              f"{label} did not train on the GPU")
        check(len(lookups) == 1, f"{label}: lookups {lookups}")
        lookup = lookups.pop()
        per_step = lookup_launches(trainer.model, lookup)
        check(per_step == {"K6": 6, "K3": 0}, f"{label}: {per_step} a step, expected K6 6")
        expected = {k: 0 for k in counts}
        expected.update({k: n * steps for k, n in per_step.items()})
        check_counts(counts, expected, f"{label} run_model (segmat)")
        check(scatters[0] == 0, f"{label}: index_add_ reached {scatters[0]} times under segmat")
        check(len(events) == steps + 1, f"{label}: {len(events) - 1} steps timed, expected {steps}")
        epoch_s = events[0].elapsed_time(events[-1]) / 1e3
        step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
        rows[label] = (logloss, auc)
        zoo_counts[label] = counts
        log(f"zoo {label} (GPU, segmat, {lookup} lookup): TEST logloss {logloss:.4f} auc "
            f"{auc:.4f} (JAX CPU row {ref_ll:.4f} / {ref_auc:.4f}); epoch {epoch_s:.3f} s for "
            f"{steps} steps, step (CUDA events, median) {step_ms:.4f} ms; run_model "
            f"{run_s:.1f} s; launches { {k: v for k, v in counts.items() if v} } = {per_step} a "
            f"step; index_add_ 0")
        if label == ZOO_CHECKPOINT:
            # (c) served from its checkpoint: the trainer's predictions exactly
            x_test = trainer.model.feat_dict.transform(test)
            with tempfile.TemporaryDirectory(dir="build", prefix="zoo_ckpt_") as tmp:
                trainer.save(tmp)
                served = Predictor.from_checkpoint(tmp, name, batch_size=trainer.batch_size,
                                                   device=device)
                check(type(served.model) is type(trainer.model) and served.device == device
                      and all(v.is_cuda for v in served.params.values()),
                      f"{label} checkpoint: model or device")
                got = served.predict(x_test)
            want = trainer.predict(x_test)
            check(got.shape == (len(test["label"]),) and np.array_equal(got, want),
                  f"{label} served from its checkpoint: max|dp| "
                  f"{float(np.abs(got - want).max())} against the trainer's predict")
            log(f"zoo {label}: Predictor.from_checkpoint on the card, {len(got)} ua.test rows at "
                f"batch {trainer.batch_size}, equal to the trainer's predict")
        del trainer
    for label, (ref_ll, ref_auc) in ZOO_ROWS.items():
        logloss, auc = rows[label]
        check(abs(logloss - ref_ll) <= ZOO_LOGLOSS_BAND,
              f"{label} TEST logloss {logloss} outside {ref_ll} +- {ZOO_LOGLOSS_BAND}")
        check(abs(auc - ref_auc) <= ZOO_AUC_BAND,
              f"{label} TEST auc {auc} outside {ref_auc} +- {ZOO_AUC_BAND}")
    log(f"zoo ML-100K: all {len(ZOO_ROWS)} runs within their bands ({time.perf_counter() - t0:.1f}"
        f" s) [{card}]")

    # (b) dcn_paper_criteo: serving on the card, against the CPU
    t0 = time.perf_counter()
    model = DCN(create_criteo_features(num_buckets=NUM_BUCKETS), DCN_HP)
    names = model.packed.stackable()
    check(names is not None and len(names) == 26, "dcn_paper_criteo is not stackable")
    check(model.dnn.input_dim == 26 * 107 + 13 and model.cross.num_layers == 6
          and model.dnn.hidden_units == (1024, 1024), "dcn_paper_criteo widths")
    params = model.init_params(torch.Generator().manual_seed(0), device)
    n_params = sum(v.numel() for v in params.values())
    data = synthetic_criteo_arrays(DCN_SERVE_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    data.pop("y")
    predictor = Predictor(model, params, batch_size=DCN_SERVE_BATCH, device=device)
    preds = predictor.predict(data)
    torch.cuda.synchronize()
    check(preds.shape == (DCN_SERVE_ROWS,) and bool(np.isfinite(preds).all())
          and bool(((preds > 0) & (preds < 1)).all()), "dcn predictions")
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        predictor.predict(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wall = statistics.median(walls)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    batch_cpu = {k: torch.as_tensor(v[:DCN_SERVE_BATCH]) for k, v in data.items()}
    with torch.inference_mode():
        preds_cpu = model.apply(params_cpu, batch_cpu).numpy()
    dp = float(np.abs(preds_cpu - preds[:DCN_SERVE_BATCH]).max())
    check(dp <= DCN_PRED_TOL, f"dcn GPU vs CPU first batch: max|dp| {dp} > {DCN_PRED_TOL}")
    log(f"dcn_paper_criteo serving: {n_params} params ({4 * n_params / 1e9:.2f} GB f32), x0 "
        f"{model.dnn.input_dim} wide; predict {DCN_SERVE_ROWS} rows {wall * 1e3:.3f} ms (median "
        f"of 3), {DCN_SERVE_ROWS / wall:.1f} examples/s; GPU vs CPU, first batch of "
        f"{DCN_SERVE_BATCH}: max|dp| {dp:.3e} [{card}]")
    del predictor, params_cpu

    # training in stacked storage: step 1 and a 4-step trace against the CPU
    opt = create_optimizer("adam", DCN_HP["learning_rate"])
    sparams, names = stack_table_params(model, params)
    del params
    n_rows = (TIMED_STEPS + 4) * DCN_BATCH
    packed, layout = pack_dataset(synthetic_criteo_arrays(n_rows, num_buckets=NUM_BUCKETS, seed=11))
    idx_np = batch_indices(n_rows, DCN_BATCH, shuffle_seed=3)
    idx_np = idx_np[(idx_np >= 0).all(axis=1)]
    d = {k: torch.as_tensor(v).to(device) for k, v in packed.items()}
    idx = torch.as_tensor(idx_np).to(device)
    batch, w = gather_batch(d, idx[0])
    ub = unpack_batch(batch, layout)
    reset_counts()
    g_gpu, seen_gpu = recorded_grads(model, sparams, ub, w, names=names)
    check_counts(kernel_counts(), {"K3": 1, "K6": 0, "K7": 0}, "dcn step 1")

    def trace(p, dd, ix):
        state = TrainState(p, opt.init(p), 0, None)
        return make_train_step_stacked(model, opt, CPU_STEPS, names)(state, dd, ix, layout)[1]

    tg = trace(sparams, d, idx).cpu().numpy()
    t1 = time.perf_counter()
    p_cpu = {k: v.cpu() for k, v in sparams.items()}
    ub_cpu = {k: v.cpu() for k, v in ub.items()}
    g_cpu, seen_cpu = recorded_grads(model, p_cpu, ub_cpu, w.cpu(), names=names)
    g_signs = recorded_grads(model, p_cpu, ub_cpu, w.cpu(), card=seen_gpu, names=names)[0]
    tc = trace(p_cpu, {k: torch.as_tensor(v) for k, v in packed.items()},
               torch.as_tensor(idx_np)).numpy()
    cpu_s = time.perf_counter() - t1
    del p_cpu
    g_gpu = {k: v.cpu() for k, v in g_gpu.items()}
    plain_rel = max(rel_err(g_cpu[k], g_gpu[k]) for k in g_cpu)
    flips = sign_flips(seen_cpu["dnn"], seen_gpu["dnn"], DNN_Z_TOL, "dcn step 1 dnn, GPU vs CPU",
                       near_tol=DNN_Z_TOL)
    rel, worst = grads_match(g_signs, g_gpu, "dcn step-1 grad GPU vs CPU on the card's signs")
    max_d, final_rel = trace_match(tg, tc, "dcn loss trace")
    log(f"dcn_paper_criteo training GPU vs CPU (CPU {cpu_s:.1f} s): step-1 grads of "
        f"{len(g_gpu)} leaves, worst max|d|/max|ref| {plain_rel:.3e} as run, {rel:.3e} ({worst}) "
        f"on the card's signs; relu derivatives read on the other side of 0: {flips} of "
        f"{sum(z.numel() for z in seen_cpu['dnn'])}; trace GPU {tg.tolist()} CPU {tc.tolist()}: "
        f"max|d| {max_d:.3e}, final rel {final_rel:.3e}")
    del g_gpu, g_cpu, g_signs, seen_gpu, seen_cpu

    # TIMED_STEPS stacked steps, counts from 0
    step = make_train_step_stacked(model, opt, 1, names)
    state = TrainState(sparams, opt.init(sparams), 0, None)
    for i in range(3):
        state, _ = step(state, d, idx[i:i + 1], layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    losses = []
    t1 = time.perf_counter()
    events[0].record()
    for i in range(TIMED_STEPS):
        j = i % len(idx_np)
        state, loss = step(state, d, idx[j:j + 1], layout)
        losses.append(loss)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    dcn_counts = kernel_counts()
    check_counts(dcn_counts, {k: TIMED_STEPS * (k == "K3") for k in dcn_counts},
                 f"dcn {TIMED_STEPS} stacked steps")
    check(bool(torch.isfinite(torch.cat(losses)).all()), "dcn: non-finite loss in the timed steps")
    step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    peak = torch.cuda.max_memory_allocated()
    box = {"state": state}

    def one_step():
        box["state"], _ = step(box["state"], d, idx[:1], layout)

    kernel_ms = profile_device(one_step, step_ms, "dcn_paper_criteo train steps", n=3)
    log(f"dcn_paper_criteo train steady: {TIMED_STEPS} stacked steps at batch {DCN_BATCH}, "
        f"launches K3 {dcn_counts['K3']}; step (CUDA events, median) {step_ms:.4f} ms, "
        f"{DCN_BATCH / step_ms * 1e3:.1f} examples/s; wall {wall * 1e3 / TIMED_STEPS:.3f} ms/step; "
        f"busy share {kernel_ms / step_ms if kernel_ms else 'not measured'}; peak memory "
        f"{peak / 1e9:.3f} GB [{card}]")
    del state, box, d, sparams

    # a 1-epoch Trainer.fit, per-table storage (K3 once a step)
    arrays = synthetic_criteo_arrays(DCN_FIT_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    n_train = int(0.9 * DCN_FIT_ROWS)
    tr_x = {k: v[:n_train] for k, v in arrays.items() if k != "y"}
    va_x = {k: v[n_train:] for k, v in arrays.items() if k != "y"}
    trainer = Trainer(DCN(create_criteo_features(num_buckets=NUM_BUCKETS), DCN_HP), DCN_HP,
                      metrics=(LogLoss(), StreamingAUC()), epoch=1, batch_size=DCN_BATCH,
                      random_seed=2019, device=device)
    reset_counts()
    t1 = time.perf_counter()
    with step_events() as events:
        trainer.fit(tr_x, arrays["y"][:n_train])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    fit_counts = kernel_counts()
    fit_steps = n_train // DCN_BATCH + 1
    check_counts(fit_counts, {k: fit_steps * (k == "K3") for k in fit_counts}, "dcn fit")
    logloss, auc = trainer.evaluate(va_x, arrays["y"][n_train:])
    check(np.isfinite(logloss) and auc > 0.5, f"dcn fit: VALID logloss {logloss}, auc {auc}")
    epoch_s = events[0].elapsed_time(events[-1]) / 1e3
    log(f"dcn_paper_criteo fit: {n_train} rows, {fit_steps} steps in {epoch_s:.3f} s (CUDA "
        f"events, {n_train / epoch_s:.1f} examples/s), fit {fit_s:.1f} s with its evals; VALID "
        f"logloss {logloss:.4f} auc {auc:.4f}; K3 {fit_counts['K3']} ({time.perf_counter() - t0:.1f}"
        f" s) [{card}]")
    return {"ml": zoo_counts, "dcn": dcn_counts}


def phase_dlrm(device):
    """dlrm_mlperf_criteo: DLRM at the MLPerf reference's widths on the
    bench's Criteo-shaped data. Serving against the CPU; per-table training
    with K3 once a step at (T, C, N) = (26, 128, 2048) under "auto" (K6, K7
    and index_add_ never): step-1 gradients on the card's relu signs and a
    4-step SGD trace against the CPU, 32 timed steps with a profile and the
    peak memory; a 1-epoch ``Trainer.fit``. Returns the timed steps'
    launches."""
    import torch

    from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.models import DLRM
    from recman_tpu_torch.serving import Predictor
    from recman_tpu_torch.training import (
        LogLoss, StreamingAUC, Trainer, TrainState, batch_indices, create_optimizer,
        gather_batch, make_train_step, pack_dataset, unpack_batch,
    )

    card = card_line()
    t0 = time.perf_counter()
    model = DLRM(create_criteo_features(num_buckets=NUM_BUCKETS), DLRM_HP)
    k = DLRM_HP["embedding_size"]
    check(model.bot_units == (512, 256, k) and model.num_fields == 27
          and model.top.input_dim == k + 351 and model.top.hidden_units == (1024, 1024, 512, 256)
          and not hasattr(model, "packed"), "dlrm_mlperf_criteo widths")
    params = model.init_params(torch.Generator().manual_seed(0), device)
    n_params = sum(v.numel() for v in params.values())
    table_bytes = sum(4 * v.numel() for n, v in params.items() if n.endswith("_feat_embed"))
    sites = [(model, "bot_activation"), (model.top, "activation")]

    # serving on the card, against the CPU
    data = synthetic_criteo_arrays(DLRM_SERVE_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    data.pop("y")
    predictor = Predictor(model, params, batch_size=DLRM_SERVE_BATCH, device=device)
    preds = predictor.predict(data)
    torch.cuda.synchronize()
    check(preds.shape == (DLRM_SERVE_ROWS,) and bool(np.isfinite(preds).all())
          and bool(((preds > 0) & (preds < 1)).all()), "dlrm predictions")
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        predictor.predict(data)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wall = statistics.median(walls)
    params_cpu = {n: v.cpu() for n, v in params.items()}
    batch_cpu = {n: torch.as_tensor(v[:DLRM_SERVE_BATCH]) for n, v in data.items()}
    with torch.inference_mode():
        preds_cpu = model.apply(params_cpu, batch_cpu).numpy()
    dp = float(np.abs(preds_cpu - preds[:DLRM_SERVE_BATCH]).max())
    check(dp <= DLRM_PRED_TOL, f"dlrm GPU vs CPU first batch: max|dp| {dp} > {DLRM_PRED_TOL}")
    log(f"dlrm_mlperf_criteo serving: {n_params} params ({4 * n_params / 1e9:.3f} GB f32, tables "
        f"{table_bytes / 1e9:.3f} GB), top MLP input {model.top.input_dim}; predict "
        f"{DLRM_SERVE_ROWS} rows {wall * 1e3:.3f} ms (median of 3), {DLRM_SERVE_ROWS / wall:.1f} "
        f"rows/s; GPU vs CPU, first batch of {DLRM_SERVE_BATCH}: max|dp| {dp:.3e} [{card}]")
    del predictor, preds

    # per-table training: step 1 and a 4-step trace against the CPU
    opt = create_optimizer(DLRM_HP["optimizer"], DLRM_HP["learning_rate"])
    n_rows = (TIMED_STEPS + 4) * DLRM_BATCH
    packed, layout = pack_dataset(synthetic_criteo_arrays(n_rows, num_buckets=NUM_BUCKETS,
                                                          seed=11))
    idx_np = batch_indices(n_rows, DLRM_BATCH, shuffle_seed=3)
    idx_np = idx_np[(idx_np >= 0).all(axis=1)]
    d = {n: torch.as_tensor(v).to(device) for n, v in packed.items()}
    idx = torch.as_tensor(idx_np).to(device)
    batch, w = gather_batch(d, idx[0])
    ub = unpack_batch(batch, layout)
    reset_counts()
    with scatter_counter() as scatters:
        g_gpu, seen_gpu = activation_recorded_grads(model, params, ub, w, sites)
    check_counts(kernel_counts(), {"K3": 1, "K6": 0, "K7": 0}, "dlrm step 1")
    check(scatters[0] == 0 and len(seen_gpu) == 7, f"dlrm step 1: index_add_ {scatters[0]}, "
          f"{len(seen_gpu)} relus recorded")
    g_gpu = {n: v.cpu() for n, v in g_gpu.items()}

    def trace(p, dd, ix):
        state, step, losses = TrainState(p, opt.init(p), 0, None), make_train_step(model, opt), []
        for i in range(CPU_STEPS):
            state, loss = step(state, dd, ix[i], layout)
            losses.append(loss)
        return torch.stack(losses)

    tg = trace(params, d, idx).cpu().numpy()
    t1 = time.perf_counter()
    ub_cpu = {n: v.cpu() for n, v in ub.items()}
    g_cpu, seen_cpu = activation_recorded_grads(model, params_cpu, ub_cpu, w.cpu(), sites)
    g_signs = activation_recorded_grads(model, params_cpu, ub_cpu, w.cpu(), sites,
                                        card=seen_gpu)[0]
    tc = trace(params_cpu, {n: torch.as_tensor(v) for n, v in packed.items()},
               torch.as_tensor(idx_np)).numpy()
    cpu_s = time.perf_counter() - t1
    del params_cpu
    plain_rel = max(rel_err(g_cpu[n], g_gpu[n]) for n in g_cpu)
    flips = sign_flips(seen_cpu, seen_gpu, DNN_Z_TOL, "dlrm step 1 relus, GPU vs CPU",
                       near_tol=DNN_Z_TOL)
    rel, worst = grads_match(g_signs, g_gpu, "dlrm step-1 grad GPU vs CPU on the card's signs")
    max_d, final_rel = trace_match(tg, tc, "dlrm loss trace")
    log(f"dlrm_mlperf_criteo training GPU vs CPU (CPU {cpu_s:.1f} s): step-1 grads of "
        f"{len(g_gpu)} leaves, worst max|d|/max|ref| {plain_rel:.3e} as run, {rel:.3e} ({worst}) "
        f"on the card's signs; relu derivatives read on the other side of 0: {flips} of "
        f"{sum(z.numel() for z in seen_cpu)} (bottom and top); trace GPU {tg.tolist()} CPU "
        f"{tc.tolist()}: max|d| {max_d:.3e}, final rel {final_rel:.3e}")
    del g_gpu, g_cpu, g_signs, seen_gpu, seen_cpu

    # TIMED_STEPS per-table steps, counts from 0
    step = make_train_step(model, opt)
    state = TrainState(params, opt.init(params), 0, None)
    del params
    for i in range(3):
        state, _ = step(state, d, idx[i], layout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_STEPS + 1)]
    losses = []
    t1 = time.perf_counter()
    with scatter_counter() as scatters:
        events[0].record()
        for i in range(TIMED_STEPS):
            state, loss = step(state, d, idx[i % len(idx_np)], layout)
            losses.append(loss)
            events[i + 1].record()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    dlrm_counts = kernel_counts()
    check_counts(dlrm_counts, {n: TIMED_STEPS * (n == "K3") for n in dlrm_counts},
                 f"dlrm {TIMED_STEPS} steps")
    check(scatters[0] == 0, f"dlrm timed steps: index_add_ {scatters[0]}")
    check(bool(torch.isfinite(torch.stack(losses)).all()), "dlrm: non-finite loss in the timed steps")
    step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    peak = torch.cuda.max_memory_allocated()
    box = {"state": state}

    def one_step():
        box["state"], _ = step(box["state"], d, idx[0], layout)

    kernel_ms = profile_device(one_step, step_ms, "dlrm_mlperf_criteo train steps", n=3)
    log(f"dlrm_mlperf_criteo train steady: {TIMED_STEPS} per-table SGD steps at batch "
        f"{DLRM_BATCH}, launches K3 {dlrm_counts['K3']} at (26, {k}, {DLRM_BATCH}); step (CUDA "
        f"events, median) {step_ms:.4f} ms, {DLRM_BATCH / step_ms * 1e3:.1f} examples/s; wall "
        f"{wall * 1e3 / TIMED_STEPS:.3f} ms/step; busy share "
        f"{kernel_ms / step_ms if kernel_ms else 'not measured'}; peak memory "
        f"{peak / 1e9:.3f} GB [{card}]")
    del state, box, d

    # a 1-epoch Trainer.fit (K3 once a step)
    arrays = synthetic_criteo_arrays(DLRM_FIT_ROWS, num_buckets=NUM_BUCKETS, seed=2019)
    n_train = int(0.9 * DLRM_FIT_ROWS)
    tr_x = {n: v[:n_train] for n, v in arrays.items() if n != "y"}
    va_x = {n: v[n_train:] for n, v in arrays.items() if n != "y"}
    trainer = Trainer(DLRM(create_criteo_features(num_buckets=NUM_BUCKETS), DLRM_HP), DLRM_HP,
                      metrics=(LogLoss(), StreamingAUC()), epoch=1, batch_size=DLRM_BATCH,
                      random_seed=2019, device=device)
    reset_counts()
    t1 = time.perf_counter()
    with step_events() as events, scatter_counter() as scatters:
        trainer.fit(tr_x, arrays["y"][:n_train])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    fit_counts = kernel_counts()
    fit_steps = n_train // DLRM_BATCH + 1
    check_counts(fit_counts, {n: fit_steps * (n == "K3") for n in fit_counts}, "dlrm fit")
    check(scatters[0] == 0, f"dlrm fit: index_add_ {scatters[0]}")
    # SGD at 0.1 moves the 0.0045-scale Glorot rows little in 88 steps: the
    # port's CPU run of this fit reads VALID AUC 0.5018, so no AUC bound
    logloss, auc = trainer.evaluate(va_x, arrays["y"][n_train:])
    check(np.isfinite(trainer.last_mean_loss) and np.isfinite(logloss) and 0.0 <= auc <= 1.0,
          f"dlrm fit: epoch loss {trainer.last_mean_loss}, VALID logloss {logloss}, auc {auc}")
    epoch_s = events[0].elapsed_time(events[-1]) / 1e3
    log(f"dlrm_mlperf_criteo fit: {n_train} rows, {fit_steps} steps in {epoch_s:.3f} s (CUDA "
        f"events, {n_train / epoch_s:.1f} examples/s), fit {fit_s:.1f} s; VALID logloss "
        f"{logloss:.4f} auc {auc:.4f}; K3 {fit_counts['K3']} ({time.perf_counter() - t0:.1f} s) "
        f"[{card}]")
    return dlrm_counts


def seq_sites(model):
    """The piecewise-linear activations a sequence model runs, as (holder,
    attribute) pairs: BST's encoders' FFN and its DNN (Dice is smooth and
    records nothing)."""
    holders = [enc for encs in getattr(model, "encoders", {}).values() for enc in encs]
    holders += [model.dnn] if model.dnn.activation is not None else []
    return [(h, "activation") for h in holders]


def activation_recorded_grads(model, params, ub, w, sites, card=None, grad_fn=None):
    """Step-1 gradients of a model with per-table storage, recording the
    pre-activation of each activation in ``sites`` ((holder, attribute)
    pairs, in call order) on the CPU. With ``card``, another run's record:
    where this run's pre-activation has the other sign, the activation and
    its derivative are taken on the card's side of 0, as
    ``recorded_grads`` does. ``grad_fn(params, ub, w)``: the gradients
    (default ``loss_and_grads``'). Returns (grads, [pre-activations])."""
    import torch

    from recman_tpu_torch.training.train_step import loss_and_grads

    seen = []

    def wrap(act):
        def recorded(z):
            i = len(seen)
            seen.append(z.detach().cpu())
            if card is None:
                return act(z)
            pos = card[i].to(z.device) > 0
            return torch.where(pos == (z > 0), act(z), torch.where(pos, z, -act(-z)))
        return recorded

    real = [getattr(h, attr) for h, attr in sites]
    for (h, attr), act in zip(sites, real):
        setattr(h, attr, wrap(act))
    try:
        grads = (grad_fn or (lambda p, b, ww: loss_and_grads(model, p, b, ww)[1]))(params, ub, w)
    finally:
        for (h, attr), act in zip(sites, real):
            setattr(h, attr, act)
    return grads, seen


def phase_seq(device):
    """The behaviour-sequence family: (a) DIN, BST and DIEN through
    ``run_model`` under "segmat", each in its band, with its launches, step
    time and busy share; (b) per model, card against CPU on one batch from
    the seed-2019 params: step-1 gradients, a 4-step trace, ``calibrate``
    and the predictions after it; (c) DIN served by ``Predictor`` at two
    batch sizes; (d) ``examples.din_synthetic.main`` for each model.
    Returns the launches of (a)."""
    import torch

    from recman_tpu_torch.examples import din_synthetic
    from recman_tpu_torch.examples.model_zoo_ml import RANDOM_SEED, run_model
    from recman_tpu_torch.ops.embedding import grad_kernel
    from recman_tpu_torch.serving import Predictor
    from recman_tpu_torch.training import (
        Trainer, TrainState, batch_indices, gather_batch, init_state, make_train_step,
        pack_dataset, unpack_batch,
    )
    from recman_tpu_torch.utils import JaxKey

    card = card_line()
    (train, valid, test), _, (x_train, x_valid, x_test) = ml_seq_tables()
    n_train = len(train["label"])
    steps = n_train // SEQ_BATCH + 1
    idx_np = batch_indices(n_train, SEQ_BATCH, shuffle_seed=ML_SEED)
    packed, layout = pack_dataset(dict(x_train, y=train["label"].astype(np.float32)))
    data = {dev: {k: torch.as_tensor(v).to(dev) for k, v in packed.items()}
            for dev in {device, torch.device("cpu")}}

    # (a) the ML-100K rows, counts from 0 around each run
    t0 = time.perf_counter()
    seq_counts, rows, trainers = {}, {}, {}
    for name, (ref_ll, ref_auc) in SEQ_ROWS.items():
        np.random.seed(RANDOM_SEED)
        reset_counts()
        t1 = time.perf_counter()
        with grad_kernel("segmat"), scatter_counter() as scatters, step_events() as events, \
                lookup_spy() as lookups:
            trainer, (logloss, auc) = run_model(name, device=device)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        counts = kernel_counts()
        check(trainer.device == device and all(v.is_cuda for v in trainer.params.values()),
              f"{name} did not train on the GPU")
        check(trainer.model.embeddings.embedding_size == 8 and
              trainer.model.feat_dict["hist_items"].max_len == 10, f"{name}: k or max_len")
        check(lookups == {"apply_dict"}, f"{name}: lookups {lookups}")
        per_step = lookup_launches(trainer.model, "apply_dict")
        check(per_step == {"K6": 7, "K3": 0}, f"{name}: {per_step} a step, expected K6 7")
        expected = {k: 0 for k in counts}
        expected["K6"] = per_step["K6"] * steps
        check_counts(counts, expected, f"{name} run_model (segmat)")
        check(scatters[0] == 0, f"{name}: index_add_ reached {scatters[0]} times under segmat")
        check(len(events) == steps + 1, f"{name}: {len(events) - 1} steps timed, expected {steps}")
        epoch_s = events[0].elapsed_time(events[-1]) / 1e3
        step_ms = statistics.median(a.elapsed_time(b) for a, b in zip(events, events[1:]))
        box = {"i": 0}
        d_card, idx_card = data[device], torch.as_tensor(idx_np).to(device)

        def one_step(trainer=trainer, d=d_card, ix=idx_card):
            with grad_kernel("segmat"):
                trainer.fit_on_batch(d, ix[box["i"] % steps], layout)
            box["i"] += 1

        kernel_ms = profile_device(one_step, step_ms, f"{name} train steps", n=3)
        rows[name], seq_counts[name], trainers[name] = (logloss, auc), counts, trainer
        log(f"seq {name} (GPU, segmat): TEST logloss {logloss:.4f} auc {auc:.4f} (row "
            f"{ref_ll:.4f} / {ref_auc:.4f}); epoch {epoch_s:.3f} s for {steps} steps, step "
            f"(CUDA events, median) {step_ms:.4f} ms, busy share "
            f"{kernel_ms / step_ms if kernel_ms else 'not measured'}; run_model {run_s:.1f} s; "
            f"launches { {k: v for k, v in counts.items() if v} } = {per_step} a step; "
            f"index_add_ 0 [{card}]")
    for name, (ref_ll, ref_auc) in SEQ_ROWS.items():
        logloss, auc = rows[name]
        check(abs(logloss - ref_ll) <= ZOO_LOGLOSS_BAND,
              f"{name} TEST logloss {logloss} outside {ref_ll} +- {ZOO_LOGLOSS_BAND}")
        check(abs(auc - ref_auc) <= ZOO_AUC_BAND,
              f"{name} TEST auc {auc} outside {ref_auc} +- {ZOO_AUC_BAND}")
    log(f"seq ML-100K: all {len(SEQ_ROWS)} models within their bands "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")

    # (b) card against CPU on the first shuffled batch, from the seed's params
    t0 = time.perf_counter()
    x_cal = {k: v[:8192] for k, v in x_train.items()}
    x_val = {k: v[:2048] for k, v in x_valid.items()}
    for name in SEQ_ROWS:
        model = trainers[name].model
        hp = dict(trainers[name].hparams)
        results = []
        for on_card, dev in ((True, device), (False, torch.device("cpu"))):
            tr = Trainer(model, hp, batch_size=SEQ_BATCH, device=dev)
            tr.state = init_state(model, tr.optimizer, JaxKey(RANDOM_SEED), device=dev)
            params = tr.state.params
            idx = torch.as_tensor(idx_np).to(dev)
            batch, w = gather_batch(data[dev], idx[0])
            ub = unpack_batch(batch, layout)
            with grad_kernel("segmat"):
                if on_card:
                    reset_counts()
                grads, seen = activation_recorded_grads(model, params, ub, w, seq_sites(model))
                if on_card:
                    check_counts(kernel_counts(), {"K6": 7, "K3": 0, "K7": 0},
                                 f"{name} step 1")
                    card_seen = seen
                else:
                    signs = activation_recorded_grads(model, params, ub, w, seq_sites(model),
                                                      card=card_seen)[0]
                state = TrainState(params, tr.optimizer.init(params), 0, None)
                step = make_train_step(model, tr.optimizer)
                losses = []
                for i in range(CPU_STEPS):
                    state, loss = step(state, data[dev], idx[i], layout)
                    losses.append(loss)
            trace = torch.stack(losses).cpu().numpy()
            calibrated = tr.calibrate(x_cal)
            preds = tr.predict(x_val)
            moments = {k: v.cpu() for k, v in tr.state.params.items() if "_dice_" in k}
            results.append((grads, seen, trace, calibrated, preds, moments))
        (g_gpu, s_gpu, tg, cal_g, p_gpu, m_gpu), (g_cpu, s_cpu, tc, cal_c, p_cpu, m_cpu) = results
        g_gpu = {k: v.cpu() for k, v in g_gpu.items()}
        plain_rel = max(rel_err(g_cpu[k], g_gpu[k]) for k in g_cpu)
        flips = (sign_flips(s_cpu, s_gpu, DNN_Z_TOL, f"{name} step 1 leaky_relu, GPU vs CPU",
                            near_tol=DNN_Z_TOL) if s_cpu else 0)
        rel, worst = grads_match(signs, g_gpu, f"{name} step-1 grad GPU vs CPU on the card's signs")
        max_d, final_rel = trace_match(tg, tc, f"{name} loss trace")
        check(cal_g == cal_c == (name != "bst"), f"{name}: calibrate returned {cal_g}, {cal_c}")
        m_rel = max((rel_err(m_cpu[k], m_gpu[k]) for k in m_cpu), default=0.0)
        check(m_rel <= SEQ_MOMENT_TOL, f"{name}: calibrated moments GPU vs CPU {m_rel}")
        dp = float(np.abs(p_gpu - p_cpu).max())
        check(np.isfinite(p_gpu).all() and dp <= SEQ_PRED_TOL,
              f"{name} predictions after calibrate GPU vs CPU: max|dp| {dp} > {SEQ_PRED_TOL}")
        log(f"seq {name} GPU vs CPU at batch {SEQ_BATCH}: step-1 grads of {len(g_gpu)} leaves, "
            f"worst max|d|/max|ref| {plain_rel:.3e} as run, {rel:.3e} ({worst}) on the card's "
            f"signs; leaky_relu derivatives read on the other side of 0: {flips} of "
            f"{sum(z.numel() for z in s_cpu)}; trace GPU {tg.tolist()} CPU {tc.tolist()}: "
            f"max|d| {max_d:.3e}, final rel {final_rel:.3e}; calibrate {cal_g}, "
            f"{len(m_gpu) // 3 if cal_g else 0} Dice layers' moments max|d|/max|ref| "
            f"{m_rel:.3e}; predictions of {len(p_gpu)} valid rows max|dp| {dp:.3e}")
    log(f"seq parity ({time.perf_counter() - t0:.1f} s) [{card}]")

    # (c) DIN served on the card with the moments its fit calibrated
    t0 = time.perf_counter()
    din = trainers["din"]
    check(not all(bool(v.eq(0).all()) for k, v in din.params.items() if "_dice_mean_" in k),
          "din serves the init moments")
    reset_counts()
    served = {}
    for bs in (SEQ_BATCH, 1024):
        predictor = Predictor(din.model, din.params, batch_size=bs, device=device)
        served[bs] = predictor.predict(x_test)
    torch.cuda.synchronize()
    check(sum(kernel_counts().values()) == 0, f"serving launched {kernel_counts()}")
    check(served[SEQ_BATCH].shape == (len(test["label"]),)
          and bool(np.isfinite(served[SEQ_BATCH]).all()), "din served predictions")
    check(np.array_equal(served[SEQ_BATCH], din.predict(x_test)),
          "din: Predictor at batch 128 differs from Trainer.predict")
    ds = float(np.abs(served[SEQ_BATCH] - served[1024]).max())
    check(ds <= SEQ_SERVE_TOL, f"din served at batch 128 and 1024: max|dp| {ds} > {SEQ_SERVE_TOL}")
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        predictor.predict(x_test)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    wall = statistics.median(walls)
    log(f"seq din serving: {len(test['label'])} ua.test rows at batch 128 and 1024, max|dp| "
        f"{ds:.3e}; predict at batch 1024 {wall * 1e3:.3f} ms (median of 3), "
        f"{len(test['label']) / wall:.1f} rows/s ({time.perf_counter() - t0:.1f} s) [{card}]")

    # (d) the synthetic sequence example, counts from 0 around each run
    t0 = time.perf_counter()
    for name, (epochs, ref_ll, ref_auc) in SYNTH_ROWS.items():
        np.random.seed(RANDOM_SEED)
        reset_counts()
        t1 = time.perf_counter()
        with grad_kernel("segmat"), scatter_counter() as scatters:
            ex, (logloss, auc) = din_synthetic.main(epoch=epochs, model_name=name, device=device)
        torch.cuda.synchronize()
        counts = kernel_counts()
        ex_steps = epochs * (1600 // SEQ_BATCH + 1)
        check(ex.device == device, f"din_synthetic {name} did not train on the GPU")
        check_counts(counts, {k: 2 * ex_steps * (k == "K6") for k in counts},
                     f"din_synthetic {name}")
        check(scatters[0] == 0, f"din_synthetic {name}: index_add_ reached {scatters[0]} times")
        check(abs(logloss - ref_ll) <= ZOO_LOGLOSS_BAND and abs(auc - ref_auc) <= ZOO_AUC_BAND,
              f"din_synthetic {name}: VALID {logloss}, {auc} outside {ref_ll} / {ref_auc} +- "
              f"{ZOO_LOGLOSS_BAND} / {ZOO_AUC_BAND}")
        log(f"seq din_synthetic {name} ({epochs} epochs, GPU, segmat, "
            f"{time.perf_counter() - t1:.1f} s): VALID logloss {logloss:.4f} auc {auc:.4f} (JAX "
            f"CPU {ref_ll:.4f} / {ref_auc:.4f}); K6 {counts['K6']} = 2 x {ex_steps} steps")
    log(f"seq din_synthetic ({time.perf_counter() - t0:.1f} s) [{card}]")
    return seq_counts


@contextlib.contextmanager
def twins_barred():
    """K1's and K4's plain twins raise for the block's length: a CUDA
    tensor must never reach them."""
    from recman_tpu_torch.ops import cin_chain, cin_interact

    saved = cin_chain.cin_chain_fm_reference, cin_interact.cin_interact_fm_reference

    def barred(*a, **k):
        raise RuntimeError("a plain twin of K1 or K4 was reached")

    cin_chain.cin_chain_fm_reference = cin_interact.cin_interact_fm_reference = barred
    try:
        yield
    finally:
        cin_chain.cin_chain_fm_reference, cin_interact.cin_interact_fm_reference = saved


@contextlib.contextmanager
def k6_shapes():
    """Count the single-table lookups' segment sums by (V, C) for the
    block's length; yields the counter."""
    import collections

    from recman_tpu_torch.ops import embedding as emb

    seen = collections.Counter()
    inner = emb.segment_matmul_from_sorted

    def spy(sids, sg, v):
        seen[(v, sg.shape[1])] += 1
        return inner(sids, sg, v)

    emb.segment_matmul_from_sorted = spy
    try:
        yield seen
    finally:
        emb.segment_matmul_from_sorted = inner


def phase_export(device):
    """Serving artifacts on the card (``Predictor.export``, ``ExportedPredictor``):
    (a) the bench xDeepFM exported as f32, load-time int8 and runtime int8
    (``tools/bench_serving.py``), each serving N_ROWS rows at BATCH; (b)
    xdeepfm_paper_criteo's per-layer CIN exported for the card and the CPU,
    served on the card; (c) QR
    embeddings on all 26 hashed fields at the bench widths: train steps
    under "segmat" against the CPU, timed, then exported as runtime int8
    and served; (d) ``examples.xdeepfm_synthetic``. Returns the launches."""
    import os
    import tempfile

    import torch

    from recman_tpu_torch.data import CAT_NAMES, create_criteo_features, synthetic_criteo_arrays
    from recman_tpu_torch.examples import xdeepfm_synthetic
    from recman_tpu_torch.models import XDeepFM
    from recman_tpu_torch.ops import embedding as emb_ops
    from recman_tpu_torch.serving import Q8, ExportedPredictor, Predictor, op_nodes
    from recman_tpu_torch.tools.bench_serving import serve_artifacts
    from recman_tpu_torch.training import (
        LogLoss, TrainState, Trainer, batch_indices, gather_batch, make_train_step, unpack_batch,
    )

    card = card_line()
    k = HPARAMS["embedding_size"]
    launches = {}
    os.makedirs("build", exist_ok=True)
    tmp_dir = tempfile.TemporaryDirectory(dir="build")
    tmp = tmp_dir.name

    # (a) the bench xDeepFM: f32, load-time int8, runtime int8
    t0 = time.perf_counter()
    model = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), HPARAMS)
    predictor = Predictor(model, model.init_params(torch.Generator().manual_seed(0)),
                          batch_size=BATCH)
    data = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=7)
    data.pop("y")
    live = predictor.predict(data)
    with twins_barred():
        res = serve_artifacts(predictor, data, os.path.join(tmp, "bench"), BATCH)
    f32, q8, rq8 = res["f32"], res["load_int8"], res["runtime_int8"]
    ops = op_nodes(os.path.join(tmp, "bench", "f32"))
    check(ops == {"recman_tpu_torch.cin_chain_fwd.default"}, f"the CUDA artifact's ops: {ops}")
    n_batches = -(-N_ROWS // BATCH)
    reset_counts()
    with twins_barred():
        again = f32["served"].predict(data)
    torch.cuda.synchronize()
    counts = kernel_counts()
    check_counts(counts, {"K1": n_batches, "K1 save": 0, "K4": 0},
                 f"exported predict of {N_ROWS} rows")
    launches["K1"] = counts["K1"]
    d_live = float(np.abs(f32["preds"] - live).max())
    d_rt = float(np.abs(rq8["preds"] - f32["preds"]).max())
    d_q = float(np.abs(rq8["preds"] - q8["preds"]).max())
    check(np.array_equal(again, f32["preds"]), "the f32 artifact: two predict calls differ")
    check(d_live <= EXPORT_TOL, f"f32 artifact vs live Predictor: max|d| {d_live}")
    check(0 < d_rt < INT8_TOL, f"runtime int8 vs f32: max|d| {d_rt}")
    check(d_q <= EXPORT_TOL, f"runtime int8 vs load-time int8: max|d| {d_q}")
    shrink = f32["table_bytes"] / rq8["table_bytes"]
    check(abs(shrink - 4 * k / (k + 4)) < 1e-9 and q8["table_bytes"] == f32["table_bytes"],
          f"table bytes f32 {f32['table_bytes']}, load int8 {q8['table_bytes']}, runtime int8 "
          f"{rq8['table_bytes']}")
    check(all(rq8["served"].params[n + Q8].dtype == torch.int8
              and rq8["served"].params[n + Q8].is_cuda for n in rq8["served"].meta["quantized"]),
          "runtime int8 tables not int8 on the card")
    log(f"export (a) bench xDeepFM, {N_ROWS} rows at batch {BATCH} ({n_batches} batches): f32 "
        f"artifact vs live Predictor max|d| {d_live:.3e}; K1 {counts['K1']} launches as the "
        f"op node, plain twins never reached; runtime int8 vs f32 {d_rt:.3e}, vs load int8 "
        f"{d_q:.3e}; table bytes on the card f32 {f32['table_bytes']}, load int8 "
        f"{q8['table_bytes']}, runtime int8 {rq8['table_bytes']} (f32 / runtime = {shrink:.4f})")
    for mode, r in res.items():
        log(f"  {mode}: {r['examples_per_s']:.1f} examples/s (median of 3 predict calls), blob "
            f"{r['blob_bytes']} bytes beside {r['table_bytes']} table bytes, export "
            f"{r['export_s']:.2f} s, load {r['load_s']:.2f} s [{card}]")
    live_wall = []
    for _ in range(3):
        t1 = time.perf_counter()
        predictor.predict(data)
        live_wall.append(time.perf_counter() - t1)
    log(f"  live Predictor: {N_ROWS / statistics.median(live_wall):.1f} examples/s (median of 3) "
        f"[{card}]; (a) {time.perf_counter() - t0:.1f} s")
    del predictor, res, f32, q8, rq8, live, again

    # (b) xdeepfm_paper_criteo: the per-layer CIN, K4 three times a batch
    t0 = time.perf_counter()
    pm = XDeepFM(create_criteo_features(num_buckets=NUM_BUCKETS), PAPER_HP)
    pp = Predictor(pm, pm.init_params(torch.Generator().manual_seed(1)), batch_size=PAPER_BATCH)
    pdata = synthetic_criteo_arrays(PAPER_SERVE_ROWS, num_buckets=NUM_BUCKETS, seed=8)
    pdata.pop("y")
    plive = pp.predict(pdata)
    # a portable artifact: the card's program keeps K4, the CPU's is plain
    pdir = pp.export(os.path.join(tmp, "paper"), pdata, platforms=("cuda", "cpu"))
    ops, cpu_ops = op_nodes(pdir, "cuda"), op_nodes(pdir, "cpu")
    check(ops == {"recman_tpu_torch.cin_interact_fwd.default"} and not cpu_ops,
          f"paper artifact's ops: card {ops}, CPU {cpu_ops}")
    served = ExportedPredictor.load(pdir)
    reset_counts()
    with twins_barred():
        pgot = served.predict(pdata)
    torch.cuda.synchronize()
    counts = kernel_counts()
    p_batches = -(-PAPER_SERVE_ROWS // PAPER_BATCH)
    check_counts(counts, {"K4": 3 * p_batches, "K1": 0}, "paper exported predict")
    launches["K4"] = counts["K4"]
    dp = float(np.abs(pgot - plive).max())
    check(dp <= EXPORT_TOL, f"paper artifact vs live Predictor: max|d| {dp}")
    log(f"export (b) xdeepfm_paper_criteo, {PAPER_SERVE_ROWS} rows at batch {PAPER_BATCH}: "
        f"vs live max|d| {dp:.3e}; K4 {counts['K4']} = 3 x {p_batches} batches as the op node "
        f"of the card's program (a (cuda, cpu) artifact; the CPU's program plain) "
        f"({time.perf_counter() - t0:.1f} s)")
    del pp, served, plive, pgot

    # (c) QR on all 26 hashed fields at the bench widths
    t0 = time.perf_counter()
    qfs = create_criteo_features(num_buckets=NUM_BUCKETS)
    for name in CAT_NAMES:
        qfs[name].qr_collisions = QR_COLLISIONS
    hp = {**HPARAMS, "optimizer": "adam", "learning_rate": 1e-3}
    tr = Trainer(XDeepFM(qfs, hp), hp, metrics=(LogLoss(),), epoch=1, batch_size=BATCH,
                 random_seed=2019, device=device)
    params = tr.state.params
    v = NUM_BUCKETS + 1
    q_rows = -(-v // QR_COLLISIONS)
    check(tuple(params[f"{CAT_NAMES[0]}_feat_embed_q"].shape) == (q_rows, k)
          and tuple(params[f"{CAT_NAMES[0]}_feat_embed_r"].shape) == (QR_COLLISIONS, k)
          and not any(n.endswith("_feat_embed") for n in params), "QR params")
    qr_bytes = sum(4 * p.numel() for n, p in params.items() if "_feat_embed_" in n)
    params_cpu = {n: p.detach().cpu() for n, p in params.items()}  # before any step
    n_rows = (QR_STEPS + 4) * BATCH
    qdata = synthetic_criteo_arrays(n_rows, num_buckets=NUM_BUCKETS, seed=11)
    d, layout = tr._to_device({n: x for n, x in qdata.items() if n != "y"}, qdata["y"])
    idx_np = batch_indices(n_rows, BATCH, shuffle_seed=3)
    idx_np = idx_np[(idx_np >= 0).all(axis=1)]
    idx = tr._idx(idx_np)
    batch, w = gather_batch(d, idx[0])
    ub = unpack_batch(batch, layout)
    per_step = {(q_rows, k): 26, (QR_COLLISIONS, k): 26, (v, 1): 26}  # Q, R, linear w
    k6_step = sum(per_step.values())
    with emb_ops.grad_kernel("segmat"):
        reset_counts()
        with scatter_counter() as scatters, k6_shapes() as shapes:
            g_gpu, seen_gpu = recorded_grads(tr.model, params, ub, w)
        counts = kernel_counts()
        check_counts(counts, {"K6": k6_step, "K3": 0, "K7": 0, "K1 save": 1, "K2": 1},
                     "QR step 1")
        check(dict(shapes) == per_step and scatters[0] == 0,
              f"QR step 1: K6 by (V, C) {dict(shapes)}, index_add_ {scatters[0]}")
        opt = tr.optimizer

        def trace(p, dd, ix):
            state, step, losses = TrainState(p, opt.init(p), 0, None), make_train_step(
                tr.model, opt), []
            for i in range(CPU_STEPS):
                state, loss = step(state, dd, ix[i], layout)
                losses.append(loss)
            return torch.stack(losses)

        tg = trace(params, d, idx).cpu().numpy()
    g_gpu = {n: g.cpu() for n, g in g_gpu.items()}
    t1 = time.perf_counter()
    ub_cpu = {n: x.cpu() for n, x in ub.items()}
    g_cpu, seen_cpu = recorded_grads(tr.model, params_cpu, ub_cpu, w.cpu())
    g_signs = recorded_grads(tr.model, params_cpu, ub_cpu, w.cpu(), card=seen_gpu)[0]
    tc = trace(params_cpu, {n: x.cpu() for n, x in d.items()}, idx.cpu()).numpy()
    cpu_s = time.perf_counter() - t1
    plain_rel = max(rel_err(g_cpu[n], g_gpu[n]) for n in g_cpu)
    flips = {part: sign_flips(seen_cpu[part], seen_gpu[part], tol, f"QR step 1 {part}",
                              near_tol=tol)
             for part, tol in (("dnn", DNN_Z_TOL), ("cin", FEED_TOL))}
    rel, worst = grads_match(g_signs, g_gpu, "QR step-1 grad GPU vs CPU on the card's signs")
    max_d, final_rel = trace_match(tg, tc, "QR loss trace")
    log(f"export (c) QR (q {QR_COLLISIONS}: Q ({q_rows}, {k}), R ({QR_COLLISIONS}, {k}) per "
        f"field, {qr_bytes} table bytes): step 1 at batch {BATCH} K6 {k6_step} = 26 x (Q, R, "
        f"linear w) by (V, C) {dict(shapes)}, no index_add_; GPU vs CPU (CPU {cpu_s:.1f} s): "
        f"grads worst {plain_rel:.3e} as run, {rel:.3e} ({worst}) on the card's signs; "
        f"derivatives on the other side of 0: DNN {flips['dnn']}, CIN {flips['cin']}; trace "
        f"GPU {tg.tolist()} CPU {tc.tolist()}: max|d| {max_d:.3e}, final rel {final_rel:.3e}")
    del g_gpu, g_cpu, g_signs, seen_gpu, seen_cpu, params_cpu

    with emb_ops.grad_kernel("segmat"), scatter_counter() as scatters:
        step_ms, wall, peak, counts = timed_steps(tr, d, idx, layout, QR_STEPS)
        check_counts(counts, {"K6": k6_step * QR_STEPS, "K3": 0, "K7": 0,
                              "K1 save": QR_STEPS, "K2": QR_STEPS}, f"{QR_STEPS} QR steps")
        check(scatters[0] == 0, f"QR steps: index_add_ {scatters[0]}")
        launches["K6"] = counts["K6"] // QR_STEPS

        def one_step():
            tr.fit_on_batch(d, idx[0], layout)

        busy = profile_device(one_step, step_ms, "QR train steps", n=3)
    log(f"  QR steps: {QR_STEPS} timed, step (CUDA events, median) {step_ms:.4f} ms, "
        f"{BATCH / step_ms * 1e3:.1f} examples/s, wall {wall:.3f} ms/step, peak memory over "
        f"the held {peak / 1e9:.3f} GB; kernels {busy} ms a step [{card}]")

    qp = Predictor(tr.model, tr.state.params, batch_size=BATCH)
    serve = synthetic_criteo_arrays(N_ROWS, num_buckets=NUM_BUCKETS, seed=12)
    serve.pop("y")
    qlive = qp.predict(serve)
    qdir = qp.export(os.path.join(tmp, "qr"), serve, quantize_embeddings="runtime")
    qs = ExportedPredictor.load(qdir)
    want = sorted(f"{c}_feat_embed_{part}" for c in CAT_NAMES for part in "qr")
    check(sorted(qs.meta["quantized"]) == want
          and all(qs.params[n + Q8].dtype == torch.int8 for n in want),
          "QR runtime artifact: Q and R not int8")
    reset_counts()
    with twins_barred():
        qgot = qs.predict(serve)
    torch.cuda.synchronize()
    check_counts(kernel_counts(), {"K1": n_batches}, "QR exported predict")
    dq = float(np.abs(qgot - qlive).max())
    check(0 < dq < INT8_TOL, f"QR runtime int8 vs live Predictor: max|d| {dq}")
    log(f"  QR runtime int8 artifact: {N_ROWS} rows vs live max|d| {dq:.3e}, K1 {n_batches}; "
        f"(c) {time.perf_counter() - t0:.1f} s")
    del tr, qp, qs, d

    # (d) the synthetic example on the card: every Outdoor row falls
    t0 = time.perf_counter()
    columns, base, penalized = xdeepfm_synthetic.main(log_dir=os.path.join(tmp, "logs"))
    outdoor = columns["CATEGORY"] == "Outdoor"
    check(bool((penalized[outdoor] < base[outdoor]).all())
          and np.abs(penalized[~outdoor] - base[~outdoor]).max() <= 1e-6,
          "xdeepfm_synthetic: the override did not move only the Outdoor rows down")
    log(f"export (d) xdeepfm_synthetic on the card: Outdoor rows {base[outdoor].round(4).tolist()}"
        f" -> {penalized[outdoor].round(4).tolist()} ({time.perf_counter() - t0:.1f} s)")
    tmp_dir.cleanup()
    return launches


def kernel_record(name, source, replaces, launches, rec):
    """The kernel's entry in the ``kernels`` line. ``kernel_ms`` is the
    profile's kernel time per call where the phase profiled the kernel,
    else its event-timed ``ms``."""
    out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
           "kernel_ms": rec.get("kernel_ms") or rec["ms"], "plain_ms": rec["plain_ms"],
           "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
           "library_ms": rec["library_ms"]}
    # K3 at the large-batch N and at dlrm_mlperf_criteo's C 128, K6 at a
    # Criteo table and at the history, the launches of the zoo and sequence
    # phases
    for extra in ("large_batch", "dlrm_mlperf_criteo", "criteo", "history", "qr", "zoo_launches",
                  "seq_launches", "export_launches", "qr_launches", "parallel_launches",
                  "range_edges", "wide_cin_launches"):
        if extra in rec:
            out[extra] = rec[extra]
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available; nothing to run", file=sys.stderr)
        return 1
    from recman_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls must be off")
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    logs = cuda_build.build()
    log(f"built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    device = torch.device("cuda")
    rec = phase_kernels(device)
    rec.update(phase_interact_kernels(device))
    t0 = time.perf_counter()
    serve_k1 = phase_serving(device)
    log(f"serving phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    export = phase_export(device)
    log(f"export phase {time.perf_counter() - t0:.1f} s [{card}]")
    rec["K1"]["export_launches"] = export["K1"]
    rec["K4"]["export_launches"] = export["K4"]
    rec["K6"]["qr_launches"] = export["K6"]
    t0 = time.perf_counter()
    train, steady = phase_training(device)
    log(f"training phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide = phase_wide_cin(device)
    log(f"wide-cin phase {time.perf_counter() - t0:.1f} s [{card}]")
    rec["K1"]["wide_cin_launches"] = wide["serve"]["K1"]
    for name in ("K1 save", "K2"):
        rec[name]["wide_cin_launches"] = wide["train"][name]
    t0 = time.perf_counter()
    phase_tools(device, steady)
    log(f"tools phase {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    anchor = phase_trainer(device)
    log(f"trainer phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    per_layer = phase_per_layer(device)
    log(f"per-layer phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    large = phase_large_batch(device)
    log(f"large-batch phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    split = phase_split_lookup(device)
    log(f"split-lookup phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resilience = phase_resilience(device)
    log(f"resilience phase {time.perf_counter() - t0:.1f} s [{card}]; launches {resilience}")
    t0 = time.perf_counter()
    parallel = phase_parallel(device)
    log(f"parallel phase {time.perf_counter() - t0:.1f} s [{card}]")
    for name in ("K1 save", "K2", "K3", "K6"):
        rec[name]["parallel_launches"] = {run: c[name] for run, c in parallel.items()}
    t0 = time.perf_counter()
    zoo = phase_zoo(device)
    log(f"zoo phase {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    dlrm = phase_dlrm(device)
    log(f"dlrm phase {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    seq = phase_seq(device)
    log(f"sequence phase {time.perf_counter() - t0:.1f} s [{card}]")
    rec["K6"]["seq_launches"] = sum(c["K6"] for c in seq.values())
    rec["K6"]["zoo_launches"] = sum(c["K6"] for c in zoo["ml"].values())
    rec["K3"]["zoo_launches"] = {"dcn_paper_criteo": zoo["dcn"]["K3"],
                                 "dlrm_mlperf_criteo": dlrm["K3"]}

    fwd, bwd, seg = ("recman_tpu_torch/csrc/cin_chain_fwd.cu", "recman_tpu_torch/csrc/cin_chain_bwd.cu",
                     "recman_tpu_torch/csrc/segment_matmul.cu")
    kernels = [
        kernel_record("cin_chain_fwd", fwd, "recman_tpu/ops/cin_chain.py:218", serve_k1, rec["K1"]),
        kernel_record("cin_chain_fwd_save", fwd, "recman_tpu/ops/cin_chain.py:218",
                      train["K1"], rec["K1 save"]),
        kernel_record("cin_chain_bwd", bwd, "recman_tpu/ops/cin_chain.py:249", train["K2"], rec["K2"]),
        kernel_record("segment_matmul", seg, "recman_tpu/ops/embedding.py:405", train["K3"], rec["K3"]),
        kernel_record("segment_matmul_rows", seg, "recman_tpu/ops/embedding.py:323", anchor["K6"],
                      rec["K6"]),
        kernel_record("cin_interact_fwd", "recman_tpu_torch/csrc/cin_interact_fwd.cu",
                      "recman_tpu/ops/cin_interact.py:144", per_layer["K4"], rec["K4"]),
        kernel_record("cin_interact_bwd", "recman_tpu_torch/csrc/cin_interact_bwd.cu",
                      "recman_tpu/ops/cin_interact.py:157", per_layer["K5"], rec["K5"]),
        kernel_record("cin_chain_bwd_recompute", bwd, "recman_tpu/ops/cin_chain.py:249",
                      large["K2 recompute"], rec["K2 recompute"]),
        kernel_record("segment_matmul_vk", seg, "recman_tpu/ops/embedding.py:609", split["K7"],
                      rec["K7"]),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
