"""The one traffic generator: every cell's inputs, made from ``--seed``
and the parameters of its workload file.

Each law is a file of its own under ``portbench/traffic/``, found by its
role and name (``law``): a new law is a new file, not an edit here. The
point and mass laws are copies of ``chip_smoke.py``'s builders, so the
yardstick does not move when that script changes.

A workload file's traffic keys: each call of the closed loop hands the
front door ``batch`` instances and waits for the answers; the next call
starts when the previous one has returned.

  batch        instances a call hands the front door (1 if not given)
  sizes        {"law": <name>, ...}: ``traffic/sizes_<name>.py``
  pool         distinct calls, cycled
  set_seed     the pool (sizes and points) is drawn from this seed and
               the run's seed only orders it, so every seed's window
               does the same work; without it the pool is drawn from
               the run's seed

The configuration names the points' law (``points``) and the masses'
(``masses``, or false for an assignment). The harness draws a pool only
for a configuration that names a point law; an entry whose inputs are
not point clouds (a trainer's batches, an engine's prompts) makes its
own from the run's seed, one named stream a kind of draw
(``rng_for(seed, "tokens")``), so that the same seed gives the same
inputs.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_M32 = 0xFFFFFFFF


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of draws of ``seed``; any whole
    number, however large or negative, is a seed."""
    s = abs(int(seed))
    words = [int(seed < 0)] + [ord(ch) for ch in stream]
    while True:
        words.append(s & _M32)
        s >>= 32
        if not s:
            break
    return np.random.default_rng(np.random.SeedSequence(words))


def law(role: str, name: str):
    """The module ``portbench/traffic/<role>_<name>.py``."""
    return importlib.import_module(f"portbench.traffic.{role}_{name}")


def sizes(params: dict, count: int, rng) -> np.ndarray:
    """(count, 2) sizes by the traffic's size law."""
    return law("sizes", params["sizes"]["law"]).draw(params["sizes"], count,
                                                     rng)


@dataclass
class Instance:
    """One problem as the benchmark made it: (m, d) and (n, d) points and,
    for OT, (m,) and (n,) masses."""
    x: np.ndarray
    y: np.ndarray
    nu: Optional[np.ndarray] = None
    mu: Optional[np.ndarray] = None

    @property
    def shape(self):
        return self.x.shape[0], self.y.shape[0]


@dataclass
class Call:
    """What one call hands the system: its instances."""
    instances: List[Instance]


def make_instance(config: dict, rng, m: int, n: int) -> Instance:
    points = law("points", config["points"])
    x, y = points.draw(rng, int(m)), points.draw(rng, int(n))
    if not config.get("masses"):
        return Instance(x, y)
    masses = law("masses", config["masses"])
    return Instance(x, y, masses.draw(rng, int(m)), masses.draw(rng, int(n)))


def make_calls(config: dict, params: dict, seed: int) -> List[Call]:
    """The closed loop's pool of calls for one run."""
    fixed = params.get("set_seed")
    src = seed if fixed is None else fixed
    count, b = int(params.get("pool", 1)), int(params.get("batch", 1))
    size = sizes(params, count * b, rng_for(src, "set"))
    data_rng = rng_for(src, "data")
    pool = [Call([make_instance(config, data_rng, *size[i * b + j])
                  for j in range(b)]) for i in range(count)]
    if fixed is not None:
        pool = [pool[i] for i in rng_for(seed, "order").permutation(count)]
    return pool
