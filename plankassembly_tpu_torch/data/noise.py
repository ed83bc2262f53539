"""Input-corruption augmentation; a copy of
`plankassembly_tpu/data/noise.py` (the reference's `add_noise`): pick
1..ceil(K * noise_ratio) lines, each either deleted or shortened by up to
`noise_length` from a random end. The sequence of RNG calls is the JAX
package's, so the same `np.random.RandomState` gives the same drawing.
"""
from __future__ import annotations

import numpy as np

from plankassembly_tpu_torch.data import geometry as geo


def add_noise(lines, views, types, noise_ratio, noise_length, rng=None):
    """Corrupt a random subset of lines. Returns (lines, views, types)
    lists. `rng` is a `np.random.RandomState` (default: numpy's global
    one) or a `np.random.Generator`."""
    rng = rng or np.random
    lines = list(lines)
    high = int(np.ceil(len(lines) * noise_ratio)) + 1
    num_select = (rng.randint(1, high) if hasattr(rng, "randint")
                  else int(rng.integers(1, high)))
    indices = rng.choice(len(lines), num_select, replace=False)

    for index in indices:
        if rng.random() > 0.5:
            lines[index] = None  # delete
            continue
        line = lines[index]
        length = geo.length(line)
        noise = float(np.round(rng.random() * noise_length, 3))
        if length <= noise:
            lines[index] = None  # too short after shortening: delete
        elif rng.random() > 0.5:  # keep [0, length - noise]
            lines[index] = geo.linestring(np.stack(
                [geo.interpolate(line, 0.0), geo.interpolate(line, -noise)]))
        else:  # keep [noise, length]
            lines[index] = geo.linestring(np.stack(
                [geo.interpolate(line, noise), geo.interpolate(line, length)]))

    kept = [(l, v, t) for l, v, t in zip(lines, views, types) if l is not None]
    return ([k[0] for k in kept], [k[1] for k in kept], [k[2] for k in kept])
