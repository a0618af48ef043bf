"""Path-form queries over a store's workflows (paper §V, ``prov_query(path,
cells)``).

Requests come in cycles: each cycle holds every workflow once forward and
once backward, in an order drawn from the seed, so every seed asks for the
same work in another order.  A query's cells are a contiguous row-major
run covering ``selectivity`` of its start array's cells, at an offset drawn
from the seed.
"""

from __future__ import annotations

import numpy as np


def region(shape, selectivity: float, rng: np.random.Generator) -> np.ndarray:
    """A contiguous row-major run of ``max(1, n * selectivity)`` cells of an
    array of ``shape`` at a random offset: ``[k, ndim]`` indices."""
    n = int(np.prod(shape))
    k = max(1, int(n * selectivity))
    start = int(rng.integers(0, n - k + 1))
    return np.stack(np.unravel_index(np.arange(start, start + k), shape), axis=1)


def requests(params: dict, info: dict, rng: np.random.Generator):
    chains = info["chains"]
    slots = [(c, fwd) for c in range(len(chains)) for fwd in (True, False)]
    while True:
        for i in rng.permutation(len(slots)):
            c, fwd = slots[i]
            path = chains[c]["path"] if fwd else chains[c]["path"][::-1]
            shape = chains[c]["shapes"][0] if fwd else chains[c]["shapes"][-1]
            yield {"kind": "query", "form": "path", "path": path,
                   "cells": region(shape, params["selectivity"], rng),
                   "merge": params["merge"], "workflow": c}
