"""Pallas QC-LDPC kernel (ops/ldpc_pallas.py): interpret mode and the
Triton lowering, on CPU.

The numpy int-arithmetic golden model here is the design study for the
kernel's numeric recipe: int8 posteriors in the delta-update tile form
REQUIRE bounded message magnitudes (MSG_CLIP) — with full-range
messages the saturating posterior clip is inconsistent with the stored
messages and the decode hits an error floor. The kernel must stay
bit-exact with this model.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dvbs_tpu.spec import ldpc_spec
from dvbs_tpu.ops import ldpc_pallas
from dvbs_tpu.ops.ldpc_qc import qc_tables, to_qc_layout, from_qc_layout


def int_golden(llr_i8, table, n_iters, beta=1, msg_clip=ldpc_pallas.MSG_CLIP,
               post_clip=127):
    """Exact int model of the kernel's layered SCMS-OMS sweep."""
    t = qc_tables(table)
    G, q = t["G"], t["q"]
    post = to_qc_layout(llr_i8.astype(np.int32), table)
    msgs = {}
    mask0 = np.zeros((360, 1), bool)
    mask0[0] = True
    for _ in range(n_iters):
        for r in range(q):
            entries = list(t["layers"][r]) + [("p", 0), ("pp", 0)]
            vals, keys = [], []
            for e, ent in enumerate(entries):
                if ent[0] == "p":
                    tile = post[G + r]
                elif ent[0] == "pp":
                    tile = np.roll(post[G + q - 1], 1, axis=0) if r == 0 \
                        else post[G + r - 1]
                else:
                    tile = np.roll(post[ent[0]], ent[1], axis=0)
                old = msgs.get((r, e), np.zeros_like(tile))
                vals.append(tile - old)
                keys.append(((r, e), ent, old))
            D = len(vals)
            a = np.abs(np.stack(vals))
            neg = np.stack(vals) < 0
            if r == 0:
                a[D - 1] = np.where(mask0, 10**6, a[D - 1])
                neg[D - 1] = np.where(mask0, False, neg[D - 1])
            am = np.argmin(a, axis=0)
            m1 = np.min(a, axis=0)
            a2 = a.copy()
            np.put_along_axis(a2, am[None], 10**6, 0)
            m2 = np.min(a2, axis=0)
            par = neg.sum(axis=0) % 2
            for e, (key, ent, old) in enumerate(keys):
                excl = np.where(am == e, m2, m1)
                mag = np.clip(excl - beta, 0, msg_clip)
                news = np.where(par ^ neg[e], -1, 1) * mag
                if r == 0 and e == D - 1:
                    news = np.where(mask0, 0, news)
                flip = (old != 0) & (np.sign(old) != np.sign(news)) & \
                    (news != 0)
                news = np.where(flip, 0, news)
                delta = news - old
                msgs[key] = news

                def upd(tile, d):
                    return np.clip(tile + d, -post_clip, post_clip)
                if ent[0] == "p":
                    post[G + r] = upd(post[G + r], delta)
                elif ent[0] == "pp":
                    if r == 0:
                        post[G + q - 1] = upd(post[G + q - 1],
                                              np.roll(delta, -1, 0))
                    else:
                        post[G + r - 1] = upd(post[G + r - 1], delta)
                else:
                    post[ent[0]] = upd(post[ent[0]],
                                       np.roll(delta, -ent[1], 0))
    return (from_qc_layout(post, table) < 0).astype(np.uint8)


FRAMES = 16         # frames per noisy batch (any count works)


@pytest.fixture(scope="module")
def noisy_case():
    code = ldpc_spec.get_code("C4")
    rng = np.random.default_rng(0)
    m = rng.integers(0, 2, (FRAMES, code.K)).astype(np.uint8)
    cw = code.encode(m)
    x = 1.0 - 2.0 * cw.astype(np.float32)
    sigma = np.sqrt(10 ** (-3.0 / 10))
    y = x + rng.normal(0, sigma, x.shape).astype(np.float32)
    llr = np.asarray(ldpc_pallas.quantize_llrs(
        jnp.asarray(2.0 * y / sigma ** 2)))
    return llr, cw


def test_kernel_matches_int_golden(noisy_case):
    llr, cw = noisy_case
    for it in (1, 3):
        # fixed sweep count for bit-exact comparison with the golden
        hard, _, _ = ldpc_pallas.decode_qc_pallas(
            jnp.asarray(llr), "C4", n_iters=it, interpret=True,
            early_exit=False)
        hg = int_golden(llr, "C4", n_iters=it)
        np.testing.assert_array_equal(np.asarray(hard), hg)


@pytest.mark.parametrize("table", ["B4", "C1", "B11"])
def test_kernel_matches_int_golden_other_tables(table):
    """Bit-exactness across table families: the bench's normal-frame
    B4, the lowest-rate short C1, and the highest-rate normal B11 (most
    layers). One sweep over random LLRs is enough — golden parity tests
    the arithmetic, not convergence."""
    t = qc_tables(table)
    rng = np.random.default_rng(1)
    llr = rng.integers(-25, 26, (4, t["N"])).astype(np.int8)
    hard, _, _ = ldpc_pallas.decode_qc_pallas(
        jnp.asarray(llr), table, n_iters=1, interpret=True,
        early_exit=False)
    hg = int_golden(llr, table, n_iters=1)
    np.testing.assert_array_equal(np.asarray(hard), hg)


@pytest.mark.parametrize("table", ["B9", "C5"])
def test_kernel_repeated_groups_bit_exact(table):
    """Tables whose layers visit one group three or four times: the
    later waves re-read the group after the earlier writes, so the
    deltas accumulate in schedule order exactly as in the golden."""
    assert ldpc_pallas.kernel_tables(table)["waves"] >= 3
    t = qc_tables(table)
    rng = np.random.default_rng(2)
    llr = rng.integers(-40, 41, (2, t["N"])).astype(np.int8)
    hard, _, _ = ldpc_pallas.decode_qc_pallas(
        jnp.asarray(llr), table, n_iters=2, interpret=True,
        early_exit=False)
    np.testing.assert_array_equal(np.asarray(hard),
                                  int_golden(llr, table, n_iters=2))


def test_kernel_converges_at_3db(noisy_case):
    llr, cw = noisy_case
    hard, bad, trials = ldpc_pallas.decode_qc_pallas(
        jnp.asarray(llr), "C4", n_iters=12, interpret=True)
    assert (np.asarray(hard) == cw).all()
    assert (np.asarray(bad) == 0).all()
    trials = np.asarray(trials)
    # real per-frame convergence counts: all converge well before the
    # budget at 3 dB, and the early exit must not cost correctness
    assert (trials >= 1).all() and (trials < 12).all()


def test_kernel_early_exit_matches_full_run(noisy_case):
    """Early exit stops each frame once its online syndrome is clean;
    the hard output must match the fixed-sweep run's FEC result (both
    fully converged)."""
    llr, cw = noisy_case
    h_ee, bad_ee, tr = ldpc_pallas.decode_qc_pallas(
        jnp.asarray(llr), "C4", n_iters=12, interpret=True)
    h_fx, bad_fx, _ = ldpc_pallas.decode_qc_pallas(
        jnp.asarray(llr), "C4", n_iters=12, interpret=True,
        early_exit=False)
    assert (np.asarray(bad_ee) == 0).all()
    assert (np.asarray(bad_fx) == 0).all()
    np.testing.assert_array_equal(np.asarray(h_ee), np.asarray(h_fx))


def test_online_syndrome_agrees_with_exact_at_operating_point(noisy_case):
    """The in-kernel online count (what the early exit gates on and
    what n_bad_checks reports) vs the exact syndrome of the final hard
    bits (spec check_syndrome):

    - with the budget >= convergence the two are IDENTICAL (zero);
    - under-budget, the online count may only be CONSERVATIVE — it can
      flag a frame that actually converged during the final sweep
      (its layers saw pre-update posteriors; escalation retries it),
      but must never claim a dirty frame clean."""
    llr, cw = noisy_case
    code = ldpc_spec.get_code("C4")
    for n_iters in (12, 4):
        hard, bad, _ = ldpc_pallas.decode_qc_pallas(
            jnp.asarray(llr), "C4", n_iters=n_iters, interpret=True)
        exact = np.array([code.check_syndrome(h) for h in np.asarray(hard)])
        ok_k = np.asarray(bad) == 0
        if n_iters == 12:
            assert ok_k.all() and (exact == 0).all()
        assert not (ok_k & (exact != 0)).any(), \
            "online count claimed a dirty frame clean"


def test_full_range_messages_hit_error_floor(noisy_case):
    """The design constraint itself: msg_clip=127 must FAIL where
    MSG_CLIP succeeds (documents why the cap exists)."""
    llr, cw = noisy_case
    h127 = int_golden(llr[:, :], "C4", n_iters=12, msg_clip=127)
    errs = (h127 != cw).sum()
    assert errs > 0, "full-range messages unexpectedly converged"


def test_repeated_frames_decode_identically(noisy_case):
    """Each program decodes its own frame: copies of a frame anywhere
    in the batch converge at the original's sweep count and decode to
    the same bits, whatever their neighbours."""
    llr, cw = noisy_case
    F = 2
    batch = np.tile(llr[:F], (3, 1))
    h, nb, tr = ldpc_pallas.decode_qc_pallas(
        jnp.asarray(batch), "C4", n_iters=8, interpret=True)
    h, nb, tr = np.asarray(h), np.asarray(nb), np.asarray(tr)
    for lane in range(len(batch)):
        src = lane % F
        assert np.array_equal(h[lane], h[src]), lane
        assert tr[lane] == tr[src] and nb[lane] == nb[src]
    assert np.array_equal(h[:F], cw[:F])
    assert (nb[:F] == 0).all()


def test_kernel_any_frame_count(noisy_case):
    """One program per frame: a batch of 3 frames (a multiple of no
    block width) decodes each frame as a batch of one would."""
    llr, cw = noisy_case
    h3, b3, t3 = ldpc_pallas.decode_qc_pallas(
        jnp.asarray(llr[:3]), "C4", n_iters=12, interpret=True)
    assert np.asarray(h3).shape == (3, cw.shape[1])
    np.testing.assert_array_equal(np.asarray(h3), cw[:3])
    for f in range(3):
        h1, b1, t1 = ldpc_pallas.decode_qc_pallas(
            jnp.asarray(llr[f:f + 1]), "C4", n_iters=12, interpret=True)
        np.testing.assert_array_equal(np.asarray(h1)[0], np.asarray(h3)[f])
        assert int(t1[0]) == int(t3[f]) and int(b1[0]) == int(b3[f])


@pytest.mark.parametrize("table", ["B1", "B4", "B11", "C1", "C5", "C10"])
def test_kernel_tables_consistency(table):
    """Schedule-table invariants: every layer holds its info entries +
    the two parity entries (the rest invalid), each entry's (group,
    shift) round-trips through the packing, and `wave` counts the
    earlier entries of the same group in the layer."""
    kt = ldpc_pallas.kernel_tables(table)
    t = qc_tables(table)
    G, q, tab = kt["G"], kt["q"], kt["tab"]
    g = tab & 511
    s = (tab >> 9) & 511
    f = (tab >> 18) & 3
    w = tab >> 20
    for r in range(q):
        n_valid = int((f[r] & ldpc_pallas.F_VALID).sum())
        assert n_valid == len(t["layers"][r]) + 2
        ents = list(t["layers"][r]) + [(G + r, 0)] + \
            [(G + q - 1, 1) if r == 0 else (G + r - 1, 0)]
        for e, (ge, se) in enumerate(ents):
            assert (g[r, e], s[r, e]) == (ge, se)
            assert w[r, e] == [x for x, _ in ents[:e]].count(ge)
    assert kt["waves"] == int(w.max()) + 1


@pytest.mark.parametrize("table", ["B4", "C4"])
def test_kernel_lowers_for_triton(table):
    """The kernel lowers through Pallas' Triton route for a CUDA
    target (the compile to device code happens on the card)."""
    n = qc_tables(table)["N"]
    lowered = jax.jit(
        lambda x: ldpc_pallas.decode_qc_pallas(x, table, n_iters=12)
    ).trace(jnp.zeros((5, n), jnp.int8)).lower(
        lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()
