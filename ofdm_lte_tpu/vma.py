"""shard_map varying-manual-axes (vma) helpers.

Inside `shard_map(..., check_vma=True)` every value is typed with the mesh
axes it varies over. A `lax.scan` whose carry is initialized from a CONSTANT
(e.g. the turbo codec's all-zero trellis state) but updated from a VARYING
input fails the checker: the input carry is unvarying, the output carry is
varying. The fix is to declare the init varying over the same axes as the
data it will absorb — a type-level no-op on the values themselves.

`match_vma(x, ref)` does exactly that, and degrades to identity outside
shard_map, so library code can call it unconditionally.
"""
from __future__ import annotations

import jax


def _vma_of(ref):
    try:
        return tuple(jax.typeof(ref).vma)
    except Exception:
        return ()


def match_vma(x, ref):
    """Retype `x` (a pytree of arrays) as varying over the mesh axes that
    `ref` varies over. Identity outside shard_map."""
    axes = _vma_of(ref)
    if not axes:
        return x
    have = _vma_of(jax.tree.leaves(x)[0]) if jax.tree.leaves(x) else axes
    missing = tuple(a for a in axes if a not in have)
    if not missing:
        return x
    return jax.tree.map(
        lambda v: jax.lax.pcast(v, missing, to="varying"), x)
