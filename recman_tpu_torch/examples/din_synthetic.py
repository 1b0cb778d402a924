"""DIN / BST / DIEN on synthetic behavior sequences — the sequence demo.

Counterpart of ``recman_tpu/examples/din_synthetic.py``: a candidate id
and a behavior sequence tied to the same vocabulary, the label whether
the candidate shares its parity with most of the history (10% flipped).
``make_data`` draws the reference's rows from the same
``np.random.RandomState`` as numpy columns (the card's machine has no
pandas). The initial params are the reference Trainer's for seed 2019
(``utils.JaxKey``), as in ``examples.model_zoo_ml.run_model``.

Run on the GPU (or with ``--device cpu``):

    python -m recman_tpu_torch.examples.din_synthetic [--model din|bst|dien]
"""

import argparse
import logging

import numpy as np

import recman_tpu_torch
from recman_tpu_torch.features import FeatureSet, SequenceFeat, SparseFeat
from recman_tpu_torch.models import model_class
from recman_tpu_torch.training import LogLoss, RocAucScore, Trainer, init_state
from recman_tpu_torch.utils import JaxKey

log = logging.getLogger(__name__)

RANDOM_SEED = 2019


def make_data(n=2000, n_items=50, max_hist=8, seed=2019) -> dict:
    """Columns ``item_id`` (str), ``hist_items`` (lists of str) and
    ``label`` (int), the reference's rows in its order."""
    rs = np.random.RandomState(seed)
    cands, hists, labels = [], [], []
    for _ in range(n):
        hist_len = rs.randint(1, max_hist + 1)
        hist = [f"item_{i}" for i in rs.randint(0, n_items, hist_len)]
        cand_id = rs.randint(0, n_items)
        hist_parity = np.mean([int(h.split("_")[1]) % 2 for h in hist])
        labels.append(int((cand_id % 2 == round(hist_parity)) ^ (rs.rand() < 0.1)))
        cands.append(f"item_{cand_id}")
        hists.append(hist)
    hist_col = np.empty(n, dtype=object)
    hist_col[:] = hists
    return {"item_id": np.array(cands, dtype=object), "hist_items": hist_col,
            "label": np.array(labels, dtype=np.int64)}


def main(epoch=3, batch_size=128, model_name="din", device=None):
    """Train on the first 80% of the rows, evaluate on the rest. Returns
    (trainer, [valid logloss, valid auc])."""
    recman_tpu_torch.config_logger()
    data = make_data()

    feat_dict = FeatureSet()
    item = SparseFeat("item_id", feat_size=len(np.unique(data["item_id"])))
    feat_dict["item_id"] = item
    feat_dict["hist_items"] = SequenceFeat("hist_items", id_feat=item, max_len=8)
    feat_dict.initialize(data)

    hp = {"learning_rate": 0.01, "optimizer": "adam"}
    trainer = Trainer(
        model_class(model_name)(feat_dict), hp, metrics=(LogLoss(), RocAucScore()), epoch=epoch,
        batch_size=batch_size, random_seed=RANDOM_SEED, device=device,
    )
    # the JAX Trainer's initial state for the seed (jax.random.PRNGKey)
    trainer.state = init_state(trainer.model, trainer.optimizer, JaxKey(RANDOM_SEED),
                               device=trainer.device)
    n_train = int(len(data["label"]) * 0.8)
    x_all = feat_dict.transform(data)
    x_train = {k: v[:n_train] for k, v in x_all.items()}
    x_valid = {k: v[n_train:] for k, v in x_all.items()}
    trainer.fit(x_train, data["label"][:n_train], X_valid=x_valid,
                y_valid=data["label"][n_train:])
    res = trainer.evaluate(x_valid, data["label"][n_train:])
    log.info("%s synthetic: VALID logloss=%.4f auc=%.4f", model_name.upper(), res[0], res[1])
    return trainer, res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="din", choices=["din", "bst", "dien"])
    ap.add_argument("--epoch", type=int, default=None,
                    help="default: 3 for din, 15 for bst and dien (the transformer "
                         "needs more passes than the tailored attention pooling on "
                         "this task)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    main(model_name=args.model,
         epoch=args.epoch if args.epoch is not None
         else (15 if args.model in ("bst", "dien") else 3),
         device=args.device)
