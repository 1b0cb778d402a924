"""xDeepFM on Criteo (a TSV or synthetic rows): the scale configuration.

Counterpart of ``recman_tpu/examples/criteo_xdeepfm.py`` (:28-112): 26
hashed categorical fields and 13 log1p dense ones, batch 4096, Adam at
0.001, one epoch, a 90/10 train/valid split, then the VALID logloss and
streaming AUC. Without ``tsv`` the rows are synthetic
(``synthetic_criteo_arrays``, or the calibrated generator with
``calibrated=True``). ``tsv`` reads a Criteo TSV with the native C++
parser (``data.load_criteo_tsv_native``, one multithreaded pass straight
to encoded arrays, as the reference's ``native=True``), or with the
pandas loader (``data.load_criteo_tsv``) under ``native=False`` or, with
a warning, when the parser does not build. A machine without pandas has
only the native path.

``large_batch=True`` is the reference's config-5 recipe (:72-89): batch
65,536 when ``batch_size <= 4096`` (the command line's default), a peak
learning rate sqrt-scaled from base batch 8192, a warmup of
``min(12, max(total_steps // 10, 1))`` steps and cosine decay to the end.

``embedding_size`` 10 (the xDeepFM paper's Criteo setting) is not a
power of two, so the CIN runs its per-layer kernels (K4, K5) rather than
the fused chain.

Run on the GPU (or with ``--device cpu``):

    python -m recman_tpu_torch.examples.criteo_xdeepfm [--rows 200000] [--embedding-size 10]
    python -m recman_tpu_torch.examples.criteo_xdeepfm --tsv day_0.tsv [--no-native]
"""

import argparse
import logging

import recman_tpu_torch
from recman_tpu_torch.data import (
    calibrated_criteo_arrays,
    create_criteo_features,
    load_criteo_tsv,
    load_criteo_tsv_native,
    synthetic_criteo_arrays,
)
from recman_tpu_torch.data.native_loader import NativeBuildError
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.training import (
    LogLoss,
    StreamingAUC,
    Trainer,
    create_optimizer,
    sqrt_scaled_lr,
    warmup_schedule,
)

log = logging.getLogger(__name__)


def main(tsv=None, rows=200_000, num_buckets=100_000, epoch=1, batch_size=4096,
         learning_rate=0.001, embedding_size=16, native=True, optimizer="adam",
         calibrated=False, large_batch=False, device=None):
    """Returns (trainer, [valid logloss, valid auc])."""
    recman_tpu_torch.config_logger()
    feat_dict = create_criteo_features(num_buckets=num_buckets)

    if tsv:
        data = None
        if native:
            try:
                data = load_criteo_tsv_native(tsv, num_buckets=num_buckets, max_rows=rows)
            except NativeBuildError as e:  # no g++ toolchain: the pandas path
                log.warning("native parser unavailable (%s); pandas path", e)
        if data is None:
            raw = load_criteo_tsv(tsv, max_rows=rows)
            y = raw.pop("y")
            data = feat_dict.transform(raw, y=y)
    elif calibrated:
        data = calibrated_criteo_arrays(rows, num_buckets=num_buckets)
    else:
        data = synthetic_criteo_arrays(rows, num_buckets=num_buckets)

    n = len(data["y"])
    split = int(n * 0.9)
    train = {k: v[:split] for k, v in data.items()}
    valid = {k: v[split:] for k, v in data.items()}
    y_valid = valid.pop("y")

    if large_batch:
        if batch_size <= 4096:  # the command line's default: bump to config 5
            batch_size = 65_536
        total_steps = (split // batch_size + 1) * epoch
        peak = sqrt_scaled_lr(learning_rate, batch_size, base_batch_size=8192)
        optimizer = create_optimizer(
            optimizer if isinstance(optimizer, str) else "adam",
            warmup_schedule(peak, min(12, max(total_steps // 10, 1)), total_steps,
                            decay="cosine"),
        )
        log.info("large-batch recipe: batch=%d, sqrt-scaled peak lr=%.2e, "
                 "warmup+cosine over %d steps", batch_size, peak, total_steps)

    hp = {
        "learning_rate": learning_rate,
        "optimizer": optimizer,
        "embedding_size": embedding_size,
        "cin_cross_layer_units": (100, 100),
        "cin_dropout": (1, 1, 1),
        "deep_hidden_units": (400, 400),
        "deep_dropout": (1.0, 1.0, 1.0),
    }
    model = XDeepFM(feat_dict, hp)
    trainer = Trainer(
        model, hp, metrics=(LogLoss(), StreamingAUC()), epoch=epoch,
        batch_size=batch_size, random_seed=2019, device=device,
    )
    trainer.fit(train, train["y"])
    res = trainer.evaluate(valid, y_valid)
    kind = "" if tsv else (" (calibrated synthetic)" if calibrated else " (synthetic)")
    log.info("Criteo%s: VALID logloss=%.4f auc=%.4f", kind, res[0], res[1])
    return trainer, res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tsv", default=None)
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--buckets", type=int, default=100_000)
    ap.add_argument("--epoch", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--no-native", action="store_true",
                    help="read the TSV with the pandas loader, not the native C++ parser")
    ap.add_argument("--embedding-size", type=int, default=16)
    ap.add_argument("--optimizer", default="adam",
                    help="adam | adam_bf16m | rowwise_adam | adagrad | lamb | ...")
    ap.add_argument("--large-batch", action="store_true",
                    help="the config-5 recipe: batch 65,536 and sqrt-scaled warmup+cosine; "
                         "pass --rows proportionally more")
    ap.add_argument("--calibrated", action="store_true",
                    help="published-stats-calibrated synthetic generator instead of the bench one")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    main(tsv=args.tsv, rows=args.rows, num_buckets=args.buckets, epoch=args.epoch,
         batch_size=args.batch_size, embedding_size=args.embedding_size,
         native=not args.no_native, optimizer=args.optimizer, calibrated=args.calibrated,
         large_batch=args.large_batch, device=args.device)
