"""Best-model tracking epoch callback.

Reference: BestModelFinder (recman/tf/BestModelFinder.py:9-68). One
deliberate fix: the reference hardcodes lower-is-better
(BestModelFinder.py:49) even though its metrics expose
``higher_the_better`` — a latent bug (SURVEY.md §2.6). We respect the first
metric's direction; pass ``lower_is_better=True`` to reproduce the
reference behavior exactly.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


class BestModelFinder:
    def __init__(self, save_model=False, save_dir="./best_ckpt", lower_is_better=None):
        self._best_score = None
        self._best_eval_results = None
        self._model = None
        self.save_model = save_model
        self.save_dir = save_dir
        self.lower_is_better = lower_is_better

    @property
    def best_score(self):
        return self._best_score

    @property
    def best_eval_results(self):
        return self._best_eval_results

    @property
    def best_model(self):
        return self._model

    def _improved(self, score, metric) -> bool:
        if self._best_score is None:
            return True
        if self.lower_is_better is None:
            lower = not getattr(metric, "higher_the_better", False)
        else:
            lower = self.lower_is_better
        return score < self._best_score if lower else score > self._best_score

    def __call__(self, **kwargs):
        trainer = kwargs["model"]  # the Trainer (reference passes the model)
        eval_results = kwargs["eval_results"]
        assert trainer is not None and eval_results is not None

        # score = first metric of the last non-empty result set (valid when
        # present, else train) — reference BestModelFinder.py:46-47
        results = [r for r in eval_results if r]
        score = results[-1][0]
        first_metric = trainer.metrics[0] if trainer.metrics else None

        if self._improved(score, first_metric):
            log.info("A better model is found! %s", results)
            self._best_score = score
            self._best_eval_results = results
            self._model = trainer
            if self.save_model:
                trainer.save(self.save_dir)
                # dataframe-sample sidecar next to the checkpoint
                # (reference pickles df_all alongside hparams/feat_dict,
                # BestModelFinder.py:61-68; hparams + feat_dict sidecars
                # are written by trainer.save already)
                df_all = kwargs.get("df_all")
                if df_all is not None:
                    import os
                    import pickle

                    with open(os.path.join(self.save_dir, "df_sample.pkl"),
                              "wb") as f:
                        pickle.dump(df_all, f,
                                    protocol=pickle.HIGHEST_PROTOCOL)
