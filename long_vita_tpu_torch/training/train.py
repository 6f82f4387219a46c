"""Training from a YAML stage recipe (``configs/stage*.yaml``): not ported.

Counterpart of long_vita_tpu/training/train.py (``python -m
long_vita_tpu.training.train --config recipe.yaml``). A recipe grafts stock
checkpoints (``model.graft``), loads a tokenizer and builds the data pipeline
from a corpus YAML; the repository holds neither weights nor tokenizer files,
so this entry raises until they are in it. Train through
``training.trainer.Trainer`` with parameters and packed batches meanwhile.
"""
from __future__ import annotations

_WAITS = (
    "the YAML recipe entry is not ported: it needs stock weights and a "
    "tokenizer in the repository (ROADMAP: port queue, training: train.py's "
    "recipe entry); build params and batches and use training.trainer.Trainer"
)


def build_from_recipe(recipe: dict):
    raise NotImplementedError(_WAITS)


def main(argv=None):
    raise NotImplementedError(_WAITS)


if __name__ == "__main__":
    main()
