"""The 16-row synthetic xDeepFM demo with the counterfactual weight override.

Counterpart of ``recman_tpu/examples/xdeepfm_synthetic.py`` (the
reference's ``examples/xDeepFM_test.py``): build the 16 rows, grid-search
train xDeepFM, rank the predictions, then penalize the "Outdoor" category
with ``set_weights`` and rank again. The rows are numpy columns (the
card's machine has no pandas) and the rankings are logged by
``np.argsort``. The initial params are the reference Trainer's for seed
2019 (``utils.JaxKey``), as in ``examples.din_synthetic``.

Run on the GPU (or with ``--device cpu``):

    python -m recman_tpu_torch.examples.xdeepfm_synthetic
"""

import argparse
import logging

import numpy as np

import recman_tpu_torch
from recman_tpu_torch import FeatureSet, MultiValCsvFeat, SparseFeat
from recman_tpu_torch.config import xDeepFMHyperParams as HyperParams
from recman_tpu_torch.models import XDeepFM
from recman_tpu_torch.obs import BestModelFinder, TensorBoardLogger
from recman_tpu_torch.training import LogLoss, RocAucScore, Trainer, init_state
from recman_tpu_torch.utils import JaxKey

log = logging.getLogger(__name__)

RANDOM_SEED = 2019
TB_LOG_DIR = "./logs"

# fmt: off
ROWS = [
    ["USER_1", "ITEM_1", "Outdoor",   123, "a|b|d",   1],
    ["USER_1", "ITEM_4", "Treadmill", 123, "a|b",     1],
    ["USER_1", "ITEM_3", "Outdoor",   124, "a|b",     1],
    ["USER_1", "ITEM_5", "Outdoor",   124, "a|b",     1],
    ["USER_4", "ITEM_6", "Rest",      124, "a|b",     0],
    ["USER_2", "ITEM_1", "Treadmill", 125, "b|c",     0],
    ["USER_2", "ITEM_4", "Treadmill", 125, "b|c",     0],
    ["USER_2", "ITEM_2", "Outdoor",   125, "b|c",     1],
    ["USER_2", "ITEM_5", "Outdoor",   125, "b|c",     1],
    ["USER_5", "ITEM_1", "Treadmill", 125, "b|c",     0],
    ["USER_5", "ITEM_3", "Rest",      125, "b|c",     1],
    ["USER_3", "ITEM_1", "Treadmill", 125, "a|c",     1],
    ["USER_3", "ITEM_4", "Treadmill", 125, "a|c",     1],
    ["USER_3", "ITEM_2", "Outdoor",   125, "a|c",     0],
    ["USER_6", "ITEM_2", "Outdoor",   125, "a|c",     0],
    ["USER_6", "ITEM_5", "Outdoor",   125, "a|b|c|d", 0],
]
# fmt: on
COLUMNS = ["USER_ID", "CLASS_ID", "CATEGORY", "TIMESTAMP", "HISTORICAL_CATEGORIES", "LABEL"]


def make_columns() -> dict:
    """The 16 rows as {column: numpy array}, the strings as object arrays."""
    columns = {}
    for i, name in enumerate(COLUMNS):
        values = [row[i] for row in ROWS]
        columns[name] = np.array(values, dtype=object if isinstance(values[0], str) else None)
    return columns


def _ranking(columns, preds, what):
    order = np.argsort(-preds, kind="stable")
    lines = [f"{r:>2} {columns['USER_ID'][i]} {columns['CLASS_ID'][i]} "
             f"{columns['CATEGORY'][i]:<9} {preds[i]:.6f}" for r, i in enumerate(order)]
    log.info("%s ranking:\n%s", what, "\n".join(lines))


def main(device=None, log_dir=TB_LOG_DIR):
    """Train, rank, override, rank again. Returns (columns, predictions,
    penalized predictions); the override stays set on the schema."""
    recman_tpu_torch.config_logger()
    columns = make_columns()

    feat_dict = FeatureSet()
    for name in ("USER_ID", "CLASS_ID", "CATEGORY"):
        feat_dict[name] = SparseFeat(name, feat_size=len(np.unique(columns[name])))
    feat_dict["HISTORICAL_CATEGORIES"] = MultiValCsvFeat(
        "HISTORICAL_CATEGORIES", tags=("a", "b", "c", "d")
    )
    feat_dict.initialize(columns)
    x_all = feat_dict.transform(columns)
    y = columns["LABEL"]

    hp_params = HyperParams()
    hp_params[HyperParams.LearningRate]([0.01])
    metrics = (LogLoss(), RocAucScore())
    finder = BestModelFinder()

    for sess_num, hp_val in enumerate(hp_params.grid_search()):
        tb_logger = TensorBoardLogger(hp_params, sess_num=sess_num, log_dir=log_dir)
        trainer = Trainer(
            XDeepFM(feat_dict, hp_val), hp_val, metrics=metrics, epoch=5, batch_size=128,
            random_seed=RANDOM_SEED, device=device,
        )
        # the JAX Trainer's initial state for the seed (jax.random.PRNGKey)
        trainer.state = init_state(trainer.model, trainer.optimizer, JaxKey(RANDOM_SEED),
                                   device=trainer.device)
        trainer.fit(x_all, y, tb_logger=tb_logger, epoch_callback=finder,
                    random_seed_for_mini_batch=False)
        tb_logger.close()

    log.info("Training complete. BestScore: %s", finder.best_score)
    preds = finder.best_model.predict(x_all)
    _ranking(columns, preds, "Base")

    # counterfactual: penalize Outdoor by -5 (reference xDeepFM_test.py:124-127)
    feat_dict["CATEGORY"].set_weights({"Outdoor": -5})
    feat_dict["HISTORICAL_CATEGORIES"].set_weights({"Outdoor": -5})
    penalized = finder.best_model.predict(x_all, training=False)
    _ranking(columns, penalized, "Penalized")
    return columns, preds, penalized


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--log-dir", default=TB_LOG_DIR)
    args = ap.parse_args()
    main(device=args.device, log_dir=args.log_dir)
