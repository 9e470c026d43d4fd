"""The paper's original trainers (reference ``legacy/``): Reptile and
first-order MAML with a fresh inner optimizer every batch.

Counterpart of ``meta_interpolation_tpu/legacy/``:

  * **Reptile** — k inner steps on the support pairs, then move the
    initialisation toward the adapted weights, θ ← θ + ε(θ′ − θ)
    (reference train_sepconv.py:113-141);
  * **first-order MAML** — k inner steps, the query gradient at the
    adapted weights stepped by the outer optimizer on the base weights
    (:145-180).

The steps are in :mod:`.trainers`; :mod:`.driver` and
``train_{sepconv,voxelflow,superslomo,dain}`` are the command lines.
"""
from .trainers import eval_episode, fomaml_step, reptile_step  # noqa: F401
