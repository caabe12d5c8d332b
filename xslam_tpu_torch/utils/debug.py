"""Debug checks of an engine state.

Port of ``xslam_tpu/utils/debug.py``. The reference debugs with printf
probes and ``_debug`` kernel variants (SURVEY.md §4.4); here a state's
floating leaves are checked for NaN and infinity.

A state is a nest of NamedTuples, tuples, lists and dicts whose leaves are
tensors (or numpy arrays and numbers). Leaves are named as
``jax.tree_util.keystr`` names them in the JAX package: ``.volume.value``,
``.vmaps_prev[0].v``, ``['a']``; dicts in sorted key order, as JAX flattens
them; ``None`` is no leaf.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{path}[{i}]")
    else:
        yield path, tree


def _health(t: torch.Tensor) -> dict:
    """Counts and finite range of a floating tensor, reduced on its device
    and read back in one copy."""
    nan = torch.isnan(t)
    finite = torch.isfinite(t)
    n = t.numel()
    stats = torch.stack([
        nan.sum().double(), finite.sum().double(),
        torch.where(finite, t, torch.inf).min().double(), torch.where(finite, t, -torch.inf).max().double(),
    ]).tolist()
    n_nan, n_finite, lo, hi = int(stats[0]), int(stats[1]), stats[2], stats[3]
    return {
        "shape": tuple(t.shape),
        "nan_frac": n_nan / n,
        "inf_frac": (n - n_finite - n_nan) / n,
        "min": lo if n_finite else None,
        "max": hi if n_finite else None,
    }


def state_health(state) -> Dict[str, dict]:
    """Per-leaf NaN/Inf/range diagnostics of any engine state: for each
    floating leaf its shape, the shares of NaN and of infinite entries, and
    the least and largest finite entry (None where there is none)."""
    out = {}
    for name, leaf in _leaves(state):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        if t.is_floating_point():
            out[name] = _health(t)
    return out


def assert_state_sane(state, allow_nan_keys=("vmaps_prev", "nmaps_prev", "t_prev")):
    """Raise if unexpected NaN/Inf appear (model maps legitimately carry NaN
    miss sentinels)."""
    for name, h in state_health(state).items():
        if any(k in name for k in allow_nan_keys):
            continue
        if h["nan_frac"] > 0 or h["inf_frac"] > 0:
            raise AssertionError(f"non-finite values in {name}: {h}")
