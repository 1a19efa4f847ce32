"""Driver entry points: single-chip jittable step + multi-chip dry run."""
import importlib.util
import os

import numpy as np
import pytest
import jax


def _load():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_compiles_and_runs():
    mod = _load()
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    ber, papr = jax.tree.map(np.asarray, out)
    assert ber.shape == (2,)
    assert 0.0 <= ber[0] <= 1.0 and ber[1] < ber[0]  # 25 dB beats 15 dB
    assert np.all(papr > 3.0)


# slow lane: `chip_smoke.py --multi` runs dryrun_multichip on four GPUs
@pytest.mark.slow
def test_dryrun_multichip_8():
    mod = _load()
    mod.dryrun_multichip(8)   # asserts internally
