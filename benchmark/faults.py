"""Faults planted under the timed path, to show that the output check
catches them (``calibrate.py`` on the card, ``tests/test_bench_check.py``
on the CPU). Each is installed in place of the config module's builder
for one run and removed after it.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


def _half_rows(batch: dict, draws):
    """The first half of a two-tower batch and of its draws."""
    h = max(1, len(batch["expression"]) // 2)
    draws = dataclasses.replace(draws, **{f.name: getattr(draws, f.name)[:h]
                                          for f in dataclasses.fields(draws)})
    return {k: v[:h] for k, v in batch.items()}, draws


def _half_slide(batch: dict) -> dict:
    """The slide with the second half of its real spots masked out."""
    real = int(batch["mask"].sum())
    mask = batch["mask"].clone()
    mask[real // 2:] = False
    return dict(batch, mask=mask)


def half_batch(step):
    """Half of each batch left out, the loss the mean over the rest."""
    def faulty(state, batch, *args):
        if "mask" in batch:
            return step(state, _half_slide(batch), *args)
        half, draws = _half_rows(batch, args[0])
        return step(state, half, draws, *args[1:])
    return faulty


def unchanged(step):
    """A step that computes its loss and leaves the state as it was."""
    def faulty(state, batch, *args):
        saved = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        loss = step(state, batch, *args)
        with torch.no_grad():
            state.model.load_state_dict(saved)
        return loss
    return faulty


STEP_FAULTS = {"half_batch": half_batch, "unchanged": unchanged}


def altered_answer(predict):
    """Each answer's first row shifted by one gene where the service
    produces it: every value lands on its neighbour's gene."""
    def faulty(patches):
        out = predict(patches).copy()
        out[0] = np.roll(out[0], 1)
        return out
    return faulty


@contextlib.contextmanager
def planted(cell, fault: str):
    """Run ``cell`` with ``fault``: a step fault wraps the builder's train
    step, "altered_answer" the service's ``predict``."""
    build = cell.builder
    if fault in STEP_FAULTS:
        original = build.train_step
        build.train_step = lambda cfg: STEP_FAULTS[fault](original(cfg))
        try:
            yield
        finally:
            build.train_step = original
    elif fault == "altered_answer":
        original = build.service

        def service(*args, **kwargs):
            s = original(*args, **kwargs)
            s.predict = altered_answer(s.predict)
            return s

        build.service = service
        try:
            yield
        finally:
            build.service = original
    else:
        raise KeyError(f"unknown fault {fault!r}")
