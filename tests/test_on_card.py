"""Checks that need the card (marker `gpu`; they skip elsewhere).

Run on the GPU:  JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
chip_smoke.py runs the same comparisons at bench widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvbs_tpu.ops import ldpc_pallas, viterbi
from dvbs_tpu.ops.ldpc_qc import qc_tables
from dvbs_tpu.spec import dvbs_fec

from test_ldpc_pallas import int_golden

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("table", ["B4", "C4", "B9"])
def test_ldpc_kernel_on_card_matches_golden(gpu, table):
    t = qc_tables(table)
    rng = np.random.default_rng(5)
    llr = rng.integers(-30, 31, (7, t["N"])).astype(np.int8)
    hard, _, _ = ldpc_pallas.decode_qc_pallas(
        jnp.asarray(llr), table, n_iters=3, early_exit=False)
    np.testing.assert_array_equal(np.asarray(hard),
                                  int_golden(llr, table, n_iters=3))


def test_viterbi_on_card_matches_cpu(gpu):
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, 64 * 704).astype(np.uint8)
    xy = dvbs_fec.cc_encode(bits).reshape(64, 704, 2).astype(np.float32)
    llr = (1.0 - 2.0 * xy) + rng.normal(0, 0.7, xy.shape).astype(np.float32)
    got = np.asarray(viterbi.decode_segments(jnp.asarray(llr)))
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(viterbi.decode_segments(llr))
    np.testing.assert_array_equal(got, ref)
