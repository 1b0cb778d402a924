"""xDeepFM on MovieLens-100K with a learning-rate grid search.

Counterpart of ``recman_tpu/examples/xdeepfm_ml.py`` (itself the mirror of
recman/examples/xDeepFM_ml.py:28-70): 50% subsample, 70/30 train/valid
split, lr grid {0.01, 0.005}, batch 128, seed 2019, TensorBoard logging
(the JSONL fallback without tensorboardX) and best-model tracking, then
the best model's logloss and AUC on ``ua.test``. The tables come from the
port's numpy loader as column dicts; the feature set encodes them once
and the Trainer takes the encoded dicts.

Run on the GPU (or with ``--device cpu``):

    python -m recman_tpu_torch.examples.xdeepfm_ml [--frac 0.5] [--epoch 1]

``--grad-kernel segmat --fused-grad on --shuffle-seed 2019 --device cpu``
runs on the CPU the route and shuffle that ``chip_smoke.py``'s anchor
runs on the GPU (K6's and the CIN kernels' plain twins in their place).
"""

import argparse
import logging

import recman_tpu_torch
from recman_tpu_torch.config import xDeepFMHyperParams as HyperParams
from recman_tpu_torch.data import concat_rows, create_ml_features, get_ml_dataset
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.obs import BestModelFinder, TensorBoardLogger
from recman_tpu_torch.training import LogLoss, RocAucScore, Trainer

log = logging.getLogger(__name__)

RANDOM_SEED = 2019


def main(frac=0.5, epoch=1, batch_size=128, lr_grid=(0.01, 0.005), log_dir="./logs",
         device=None):
    """Returns (finder, [test logloss, test auc])."""
    recman_tpu_torch.config_logger()
    train, valid, test, domains = get_ml_dataset(frac=frac, random_seed=RANDOM_SEED)
    # encoders fit on the union so vocabularies are shared
    # (reference examples/utils.py:73 fits on df_all)
    feat_dict = create_ml_features(concat_rows(train, valid), domains)
    x_train, x_valid, x_test = (feat_dict.transform(t) for t in (train, valid, test))

    hp_params = HyperParams()
    hp_params[HyperParams.LearningRate](list(lr_grid))
    metrics = (LogLoss(), RocAucScore())
    finder = BestModelFinder()

    for sess_num, hp_val in enumerate(hp_params.grid_search()):
        tb_logger = TensorBoardLogger(hp_params, sess_num=sess_num, log_dir=log_dir)
        model = XDeepFM(feat_dict, hp_val)
        trainer = Trainer(
            model, hp_val, metrics=metrics, epoch=epoch, batch_size=batch_size,
            random_seed=RANDOM_SEED, device=device,
        )
        trainer.fit(
            x_train, train["label"], X_valid=x_valid, y_valid=valid["label"],
            tb_logger=tb_logger, epoch_callback=finder,
        )
        tb_logger.close()

    test_res = finder.best_model.evaluate(x_test, test["label"])
    log.info(
        "Best lr=%s | valid=%s | TEST logloss=%.4f auc=%.4f",
        finder.best_model.hparams[HyperParams.LearningRate],
        finder.best_eval_results,
        test_res[0], test_res[1],
    )
    return finder, test_res


if __name__ == "__main__":
    import numpy as np

    from recman_tpu_torch.ops.embedding import fused_grad, grad_kernel

    ap = argparse.ArgumentParser()
    ap.add_argument("--frac", type=float, default=0.5)
    ap.add_argument("--epoch", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--grad-kernel", default="auto", choices=("auto", "scatter", "segmat"),
                    help="the lookups' table-gradient route (ops.embedding.grad_kernel)")
    ap.add_argument("--fused-grad", default="auto", choices=("auto", "on", "off"),
                    help="the lookups' custom backward: auto = on for CUDA")
    ap.add_argument("--shuffle-seed", type=int, default=None,
                    help="seed numpy's global generator, which draws each epoch's shuffle seed")
    args = ap.parse_args()
    if args.shuffle_seed is not None:
        np.random.seed(args.shuffle_seed)
    fused = {"auto": None, "on": True, "off": False}[args.fused_grad]
    with fused_grad(fused), grad_kernel(args.grad_kernel):
        main(frac=args.frac, epoch=args.epoch, batch_size=args.batch_size, device=args.device)
