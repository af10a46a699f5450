"""The port's plain forward-diff DP against swarm_tpu's Pallas kernel,
run as swarm_tpu's own tests run it on the CPU (interpret mode), on the
task arrays and parametrisations of tests/test_pallas_d2_diffs.py.

Kept apart from test_torch_d2_diffs.py because each interpret-mode
compile takes tens of seconds on the CPU: a file of its own runs on its
own test worker.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from swarm_tpu.ops.pallas_d2_diffs import d2_diffs_pallas

from test_torch_d2_diffs import PALLAS_CASES, reference_diffs, task_arrays


@pytest.mark.parametrize("seed,d,scores", PALLAS_CASES)
def test_reference_matches_pallas(tmp_path, seed, d, scores):
    arrays = task_arrays(tmp_path, seed, d, scores)
    lanes_q, lanes_d, qlen, dlen, B, Lmax = arrays
    mismatch, go, ge = scores
    want = np.asarray(d2_diffs_pallas(
        jnp.asarray(lanes_q), jnp.asarray(lanes_d), jnp.asarray(qlen),
        jnp.asarray(dlen), B=B, Lmax=Lmax, mismatch=mismatch, go=go, ge=ge,
        d=d, interpret=True))
    got = reference_diffs(arrays, d, scores)
    np.testing.assert_array_equal(got, want)
