"""Faults planted in the program under test, to see the check fail.

Each takes the built trainer and breaks its timed path in place, as a
later change to the program might: the step that returns its state
unchanged (the update skipped), half of each worker's batch left out (the
mean taken over the rest), the exchange between workers left out (each
step applies worker 0's own gradient). A training cell produces no token
or answer of its own, so the fourth fault of a served model has no
counterpart here.
"""

from __future__ import annotations


def state_unchanged(trainer) -> None:
    trainer._apply_update = lambda reduced: None


def half_batch(trainer) -> None:
    loss = trainer._loss

    def half(mb, w, key):
        rows = len(next(iter(mb.values())))
        return loss({k: v[:rows // 2] for k, v in mb.items()}, w, key)

    trainer._loss = half


def no_exchange(trainer) -> None:
    exchange = trainer.grad_step

    def own(flat):
        _, metrics, skip = exchange(flat)
        return flat[0].clone(), metrics, skip

    trainer.grad_step = own


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange}
