"""Faults planted in the program, to show that the comparison of
``check.py`` fails what it has to. Each is a ``Fault`` that the
``Program`` applies when it is built (``model``) and after each round
(``after_round``). A one-chip training cell can have these:

  * ``unchanged``: a step that returns its state unchanged;
  * ``half_batch``: half of each row's tokens left out, the loss the
    mean over the rest;
  * ``answer_altered``: an answer altered where it is produced: the
    round's new ``lm_head`` moved twice as far as the update said.

(The exchange between chips is not in a one-chip cell.)
"""
from __future__ import annotations

import dataclasses


class Fault:
    name = "none"

    def model(self, model, traffic):
        return model

    def after_round(self, prev, state):
        return state


class Unchanged(Fault):
    name = "unchanged"

    def after_round(self, prev, state):
        return {**state, "params": prev["params"]}


class HalfBatch(Fault):
    name = "half_batch"

    def model(self, model, traffic):
        keep = traffic["seq"] // 2
        loss = model.loss

        def half(p, b):
            return loss(p, {**b, "tokens": b["tokens"][..., :keep]})
        return dataclasses.replace(model, loss=half)


class AnswerAltered(Fault):
    name = "answer_altered"

    def after_round(self, prev, state):
        old = prev["params"]["lm_head"]["w"]
        new = state["params"]["lm_head"]["w"]
        moved = (2.0 * new.float() - old.float()).to(new.dtype)
        params = {**state["params"], "lm_head": {"w": moved}}
        return {**state, "params": params}


FAULTS = {f.name: f for f in (Unchanged, HalfBatch, AnswerAltered)}
