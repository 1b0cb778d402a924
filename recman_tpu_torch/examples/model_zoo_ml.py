"""The model zoo on MovieLens-100K: one entry point for every ported model.

Counterpart of ``recman_tpu/examples/model_zoo_ml.py``, with the
reference's protocol: ``frac`` of the ratings, a 70/30 train/valid split,
Adam at lr 1e-3, seed 2019, each model's own hparam defaults, and the
TEST logloss and AUC on ``ua.test``. The initial params are the
reference's for seed 2019, drawn from its key without JAX
(``utils.JaxKey``): on this small set one epoch's TEST AUC moves by about
0.01 between init seeds, as much as the band the rows of
``docs/model_zoo.md`` are held to. The tables come from the port's
numpy loader; the feature set encodes them once and the Trainer takes
the encoded dicts. Sequence models (``requires_sequence``: DIN, BST,
DIEN) train on the schema with each row's rated-item history
(``add_history_feature``, built over all three splits in time order).

Run on the GPU (or with ``--device cpu``):

    python -m recman_tpu_torch.examples.model_zoo_ml --model fm [--epoch 1]
"""

import argparse
import logging

import recman_tpu_torch
from recman_tpu_torch.data import (
    add_history_feature,
    concat_rows,
    create_ml_features,
    create_ml_sequence_features,
    get_ml_dataset,
)
from recman_tpu_torch.models import MODEL_REGISTRY, model_class
from recman_tpu_torch.training import LogLoss, RocAucScore, Trainer, init_state
from recman_tpu_torch.utils import JaxKey

log = logging.getLogger(__name__)

RANDOM_SEED = 2019


def run_model(model_name, frac=0.5, epoch=1, batch_size=128, hparams=None, device=None):
    """Train ``model_name`` for ``epoch`` epochs and evaluate it on the TEST
    split. Returns (trainer, [test logloss, test auc])."""
    model_cls = model_class(model_name)
    recman_tpu_torch.config_logger()
    train, valid, test, domains, index = get_ml_dataset(frac=frac, random_seed=RANDOM_SEED,
                                                        return_index=True)
    if model_cls.requires_sequence:
        # the per-user rated-item history, built in time order over all splits
        train, valid, test = add_history_feature(train, valid, test, index=index)
        feat_dict = create_ml_sequence_features(concat_rows(train, valid), domains)
    else:
        feat_dict = create_ml_features(concat_rows(train, valid), domains)
    x_train, x_valid, x_test = (feat_dict.transform(t) for t in (train, valid, test))

    hp = {"learning_rate": 0.001, "optimizer": "adam"}
    hp.update(hparams or {})
    trainer = Trainer(
        model_cls(feat_dict, hp), hp, metrics=(LogLoss(), RocAucScore()), epoch=epoch,
        batch_size=batch_size, random_seed=RANDOM_SEED, device=device,
    )
    # the JAX Trainer's initial state for the seed (jax.random.PRNGKey)
    trainer.state = init_state(trainer.model, trainer.optimizer, JaxKey(RANDOM_SEED),
                               device=trainer.device)
    trainer.fit(x_train, train["label"], X_valid=x_valid, y_valid=valid["label"])
    test_res = trainer.evaluate(x_test, test["label"])
    log.info("%s: TEST logloss=%.4f auc=%.4f", model_name, test_res[0], test_res[1])
    return trainer, test_res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="fm", choices=list(MODEL_REGISTRY))
    ap.add_argument("--frac", type=float, default=0.5)
    ap.add_argument("--epoch", type=int, default=1)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    run_model(args.model, frac=args.frac, epoch=args.epoch, batch_size=args.batch_size,
              device=args.device)
