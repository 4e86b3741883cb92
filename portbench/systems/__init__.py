"""How the harness drives one kind of system of the port and judges it.

A configuration's file names its system (``"system": "enhance"``), and the
harness imports ``portbench.systems.<system>`` and builds its ``System``
from the configuration.  A system makes a traffic mix's inputs from the
seed, calls the port's entry that the configuration names for the driver's
path (``offline`` for the ``files`` driver, ``live`` for the ``live``
driver), and compares what came back with the plain reference of
:mod:`portbench.reference`.  Its ``judge_*`` methods return the numbers that
decide ``correct``; the configuration holds their limits.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def entry(dotted: str):
    """The port's function or class named by its dotted path."""
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(module), name)


def kwargs(spec: dict) -> dict:
    """A configuration's keyword arguments, "torch.<name>" strings as torch objects."""
    return {k: getattr(torch, v[6:]) if isinstance(v, str) and v.startswith("torch.") else v
            for k, v in spec.items()}


def strata(n: int, k: int, rng: np.random.Generator) -> list[int]:
    """One index drawn from each of k equal strata of range(n) (all of them
    where n <= k), so that every part of a batch is looked at."""
    if n <= k:
        return list(range(n))
    edges = np.linspace(0, n, k + 1).astype(int)
    return [int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:])]


def given(a: np.ndarray, n: int) -> np.ndarray:
    """The first n samples that a live stream was handed from its input ``a``
    (..., L), which loops: the driver serves as many chunks as it can."""
    return np.take(a, np.arange(n) % a.shape[-1], axis=-1)


class Item:
    """One call's inputs: ``args`` for the entry, ``samples`` of input it
    carries (a two-track sample counted once), and ``label``."""

    def __init__(self, args, samples: int, label: str):
        self.args, self.samples, self.label = args, samples, label
