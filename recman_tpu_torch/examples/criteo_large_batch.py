"""xDeepFM large-batch training on Criteo-shaped rows.

Counterpart of ``recman_tpu/examples/criteo_large_batch.py``: the
large-batch recipe (linear learning-rate scaling from a small-batch base,
a warmup, cosine decay; ``--optimizer lamb`` when plain scaling stops
converging) on xDeepFM with 26 hashed fields x 100,000 buckets, 13 dense
fields, k = 16, CIN (100, 100) leaky_relu, DNN (400, 400), every keep 1,
at batch 65,536 over synthetic rows split 95/5. ``cin_remat`` is set at
batches of 131,072 and more, as in the reference; the fused chain ignores
it there too (its memory option is ``ops.cin_chain.CHAIN_SAVE_FMAPS =
False``).

Run on the GPU (or with ``--device cpu`` at a small size):

    python -m recman_tpu_torch.examples.criteo_large_batch [--batch 65536] [--rows 2000000]
        [--optimizer lamb] [--device cpu]
"""

import argparse
import logging
import time

import recman_tpu_torch
from recman_tpu_torch.data import create_criteo_features, synthetic_criteo_arrays
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.training import LogLoss, StreamingAUC, Trainer, large_batch_schedule

log = logging.getLogger(__name__)


def main(batch_size=65536, rows=2_000_000, num_buckets=100_000, epoch=1, base_lr=1e-3,
         base_batch=8192, optimizer="adam", warmup_frac=0.05, device=None):
    """Returns (trainer, [valid logloss, valid auc])."""
    recman_tpu_torch.config_logger()
    feat_dict = create_criteo_features(num_buckets=num_buckets)
    data = synthetic_criteo_arrays(rows, num_buckets=num_buckets, seed=2019)
    split = int(rows * 0.95)
    train = {k: v[:split] for k, v in data.items()}
    valid = {k: v[split:] for k, v in data.items()}
    y_valid = valid.pop("y")

    steps_per_epoch = split // batch_size + 1
    total_steps = steps_per_epoch * epoch
    schedule = large_batch_schedule(
        base_lr, batch_size, base_batch,
        warmup_steps=max(int(total_steps * warmup_frac), 1),
        total_steps=total_steps, decay="cosine",
    )
    hp = {
        "learning_rate": schedule,
        "optimizer": optimizer,
        "embedding_size": 16,
        "cin_cross_layer_units": (100, 100),
        "cin_dropout": (1, 1, 1),
        "cin_remat": batch_size >= 131072,
        "deep_hidden_units": (400, 400),
        "deep_dropout": (1.0, 1.0, 1.0),
    }
    model = XDeepFM(feat_dict, hp)
    trainer = Trainer(model, hp, metrics=(LogLoss(), StreamingAUC()), epoch=epoch,
                      batch_size=batch_size, random_seed=2019, device=device)
    t0 = time.time()
    trainer.fit(train, train["y"], random_seed_for_mini_batch=False)
    wall = time.time() - t0
    res = trainer.evaluate(valid, y_valid)
    log.info(
        "large-batch %d (%s, peak lr %.3f): VALID logloss=%.4f auc=%.4f "
        "[%.0f s, ~%.0f ex/s incl. evals]",
        batch_size, optimizer, base_lr * batch_size / base_batch,
        res[0], res[1], wall, split * epoch / wall,
    )
    return trainer, res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--epoch", type=int, default=1)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "lamb"])
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    main(batch_size=args.batch, rows=args.rows, epoch=args.epoch, optimizer=args.optimizer,
         device=args.device)
