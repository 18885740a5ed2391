"""freud_tpu_torch's TopK kernels' plain versions against freud_tpu's Pallas
kernels, run as the JAX package's own tests run them on the CPU (interpret
mode), on the same seeded numpy inputs.

Tolerances: thresholds and ``fired`` bit for bit (both packages select
exactly, or run the same float bisection; the kernel's replay of the
bisection from one exact select, ``replay_kth``, bit-equal to it); the fused forward's ``acts``
equal with at most 1 bf16 ulp on fewer than 1e-3 of entries, its selection
equal wherever the acts are, its decodes within 2e-2 of max |ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis import given, settings, strategies as st

from freud_tpu.ops.topk_fused import topk_sae_forward as jax_fused
from freud_tpu.ops.topk_threshold import _bisect as jax_bisect
from freud_tpu.ops.topk_threshold import topk_thresholds_fired as jax_thresholds
from freud_tpu_torch.ops.topk_fused import topk_sae_forward, topk_sae_forward_plain
from freud_tpu_torch.ops.topk_threshold import (
    bisect_kth,
    fired_from_bits,
    key_value,
    order_key,
    replay_kth,
    topk_thresholds_fired,
    topk_thresholds_fired_plain,
)

M, N, D = 40, 256, 16
K, K_AUX, K_MULTI = 8, 20, 32


def _acts(seed=0):
    """Post-ReLU rows with the edge rows: silent, an all-equal tie, a row
    with fewer than k positives, and a row of repeated values."""
    rng = np.random.default_rng(seed)
    a = np.maximum(rng.standard_normal((M, N)), 0).astype(np.float32)
    a[3] = 0.0
    a[5] = 0.75
    a[8] = 0.0
    a[8, :3] = (1.0, 2.0, 3.0)
    a[9] = np.repeat(rng.random(N // 8), 8)[rng.permutation(N)]
    return a


def _dead(kind, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "many":
        return rng.random(N) < 0.4
    if kind == "few":  # fewer dead than k_aux: select all dead
        d = np.zeros(N, bool)
        d[rng.choice(N, K_AUX // 2, replace=False)] = True
        return d
    if kind == "none":
        return np.zeros(N, bool)
    return np.ones(N, bool)


@pytest.mark.parametrize("dead_kind", ["many", "few", "none", "all"])
@pytest.mark.parametrize("dtype,signed,k_multi", [
    ("bf16", False, K_MULTI), ("f32", False, K_MULTI), ("bf16", True, 0),
])
def test_thresholds_bit_equal_to_jax_kernel(dtype, signed, k_multi, dead_kind):
    a = _acts()
    if signed:
        a = a - 0.5
    dead = _dead(dead_kind)
    ja = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = jax_thresholds(ja, jnp.asarray(dead), K, K_AUX, interpret=True,
                          k_multi=k_multi, signed=signed)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32)))
    ta = ta.to(torch.bfloat16) if dtype == "bf16" else ta
    before = topk_thresholds_fired.launches
    got = topk_thresholds_fired(ta, torch.from_numpy(dead), K, K_AUX,
                                k_multi=k_multi, signed=signed)
    assert topk_thresholds_fired.launches == before  # CPU: the plain version
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t_main = got[0].numpy()[:, 0]
    if not signed:
        assert t_main[3] == 0.0 and t_main[8] == 0.0  # fewer than k positives
        assert t_main[5] == np.float32(0.75)  # the tie selects the whole row
    if dead_kind == "none":
        assert np.isinf(got[1].numpy()).all()


def test_silent_rows_do_not_fire_everything():
    a = _acts()
    a[:] = 0.0
    a[0, :4] = 1.0
    _, _, _, fired = topk_thresholds_fired_plain(
        torch.from_numpy(a).to(torch.bfloat16), torch.zeros(N, dtype=torch.bool),
        K, K_AUX)
    assert fired.sum().item() == 4


def _fused_inputs(seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    w_enc = (rng.uniform(-1, 1, (N, D)) / np.sqrt(D)).astype(np.float32)
    b_enc = (rng.standard_normal(N) * 0.05).astype(np.float32)
    b_dec = (rng.standard_normal(D) * 0.1).astype(np.float32)
    w_dec = rng.standard_normal((N, D)).astype(np.float32)
    x[4] = b_dec  # a row whose acts are relu(b_enc)
    return x, w_enc, b_enc, b_dec, w_dec


@pytest.mark.parametrize("dead_kind", ["many", "few", "none"])
def test_fused_forward_plain_matches_jax_kernel(dead_kind):
    x, w_enc, b_enc, b_dec, w_dec = _fused_inputs()
    dead_f = _dead(dead_kind).astype(np.float32)
    want = jax_fused(jnp.asarray(x), jnp.asarray(w_enc.T), jnp.asarray(b_enc),
                     jnp.asarray(b_dec), jnp.asarray(w_dec), jnp.asarray(dead_f),
                     K, K_AUX, interpret=True)
    before = topk_sae_forward.launches
    got = topk_sae_forward(*(torch.from_numpy(v) for v in
                             (x, w_enc.T.copy(), b_enc, b_dec, w_dec, dead_f)),
                           K, K_AUX)
    assert topk_sae_forward.launches == before  # CPU: the plain version
    acts_j = np.asarray(want[0].astype(jnp.float32))
    acts_t = got[0].float().numpy()
    assert got[0].dtype == torch.bfloat16 and acts_t.shape == (M, N)
    differ = acts_j != acts_t
    assert differ.mean() < 1e-3
    if differ.any():  # one bf16 ulp at most
        ulp = np.abs(acts_j[differ]) * 2.0 ** -7
        assert (np.abs(acts_j - acts_t)[differ] <= ulp).all()
    same_rows = ~differ.any(axis=1)
    for i in (3, 4):  # thresholds
        np.testing.assert_array_equal(got[i].numpy()[same_rows],
                                      np.asarray(want[i])[same_rows])
    if not differ.any():
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    for i in (1, 2):  # decodes, b_dec excluded
        ref = np.asarray(want[i])
        scale = max(np.abs(ref).max(), 1e-30)
        assert np.abs(got[i].numpy() - ref).max() / scale < 2e-2


def test_fused_plain_equals_threshold_selection():
    """The fused plain version selects with the threshold plain version on
    its own acts (the kernel's selection core is shared, too)."""
    x, w_enc, b_enc, b_dec, w_dec = (torch.from_numpy(v) for v in _fused_inputs(3))
    dead = torch.from_numpy(_dead("many"))
    acts, y_main, _, t_main, t_aux, fired = topk_sae_forward_plain(
        x, w_enc.T, b_enc, b_dec, w_dec, dead.float(), K, K_AUX)
    tm, ta, _, f = topk_thresholds_fired_plain(acts, dead, K, K_AUX)
    assert torch.equal(tm, t_main) and torch.equal(ta, t_aux) and torch.equal(f, fired)
    # exactly k selected per row when no tie sits at the boundary
    counts = (acts.float() >= t_main).sum(dim=1)
    assert (counts >= K).all()
    w = w_dec.to(torch.bfloat16).float()
    keep = torch.where(acts.float() >= t_main, acts.float(), 0.0)
    assert torch.allclose(y_main, keep @ w)


# ------------------------------------------- the kernel's float-path model

INF = float("inf")
# values that stress the replay: ties, both infinities, both zeros,
# subnormals, signs
POOL = [-INF, INF, -3.0, -1.0, -1e-40, -0.0, 0.0, 1e-40, 0.5, 1.0, 1.0, 2.5, 7.0]


def _adversarial_rows(n=12):
    rng = np.random.default_rng(11)
    rows = [
        rng.standard_normal(n),                        # signed, distinct
        np.full(n, 0.75),                              # all tied
        np.full(n, -INF),                              # all -inf
        np.r_[[1.0, 2.0], np.full(n - 2, -INF)],       # fewer finite than k
        np.r_[[INF, INF], rng.standard_normal(n - 2)],  # +inf at the top
        np.r_[[-INF], np.full(n - 1, INF)],            # no finite entry
        np.r_[[-0.0, 0.0] * (n // 2)],                 # both zeros
        rng.choice(POOL, n),
        np.maximum(rng.standard_normal(n), 0.0),       # post-ReLU
    ]
    return np.stack(rows).astype(np.float32)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_replay(a, k):
    """replay_kth bit-equal to bisect_kth on every row, and equal to JAX's
    _bisect on the rows without values below 1e-20 in magnitude (XLA on the
    CPU flushes subnormal results to zero, which the bisection's halvings
    reach from there)."""
    got = replay_kth(torch.from_numpy(a), k)
    assert torch.equal(_bits(got), _bits(bisect_kth(torch.from_numpy(a), k)))
    plain = ((np.abs(a) >= 1e-20) | (a == 0)).all(axis=1)
    want = np.asarray(jax_bisect(jnp.asarray(a[plain]), k))
    np.testing.assert_array_equal(got.numpy()[plain], want)


@pytest.mark.parametrize("k", [1, 3, 11, 12, 13])
def test_replay_equals_bisection_on_adversarial_rows(k):
    """The scalar replay from one exact select is the 26-step counting
    bisection, bit for bit (torch's and JAX's), on rows with ties, ±inf,
    all -inf, fewer than k finite entries, signed values; k from 1 to n and
    past it."""
    _assert_replay(_adversarial_rows(), k)


@st.composite
def _rows_and_k(draw):
    n = draw(st.sampled_from([1, 2, 5, 8]))
    value = st.one_of(st.sampled_from(POOL),
                      st.floats(-1e6, 1e6, allow_nan=False, width=32))
    rows = draw(st.lists(st.lists(value, min_size=n, max_size=n), min_size=1, max_size=4))
    k = draw(st.one_of(st.just(1), st.just(n), st.integers(1, n + 1)))
    return np.asarray(rows, np.float32), k


@settings(max_examples=60, deadline=None)
@given(_rows_and_k())
def test_replay_equals_bisection_property(case):
    _assert_replay(*case)


def _ordered_values(dtype):
    f = torch.finfo(dtype)
    special = [-INF, -f.max, -1.0, -f.tiny, -f.smallest_normal / 4, -0.0, 0.0,
               f.smallest_normal / 4, f.tiny, 1.0, f.max, INF]
    rng = np.random.default_rng(12)
    x = torch.tensor(special + list(rng.standard_normal(200) * 10.0 ** rng.integers(-40, 38, 200)),
                     dtype=torch.float32).to(dtype)
    return x[~torch.isnan(x)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_order_key_orders_like_sort(dtype):
    """The kernel's order key sorts values as torch.sort does (-0.0 just
    below +0.0, subnormals and both infinities in place), one key a bit
    pattern, and key_value inverts it bit for bit."""
    x = _ordered_values(dtype)
    keys = order_key(x)
    by_key = x[torch.argsort(keys)]
    assert torch.equal(by_key.float(), torch.sort(x).values.float())
    assert bool((by_key.float()[1:] >= by_key.float()[:-1]).all())
    zeros = torch.tensor([-0.0, 0.0], dtype=dtype)
    assert order_key(zeros)[0] + 1 == order_key(zeros)[1]
    assert order_key(torch.tensor([-INF], dtype=dtype)).item() > 0  # below every key: 0, a NaN
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(key_value(keys, dtype).view(bits), x.view(bits))
    unique_bits = torch.unique(x.view(bits))
    assert torch.unique(keys).numel() == unique_bits.numel()


def test_fired_bits_expand_to_columns():
    words = torch.tensor([0b101, -2 ** 31, 1], dtype=torch.int32)
    got = fired_from_bits(words, 70)
    assert got.shape == (70,) and got.dtype == torch.bool
    assert got.nonzero().flatten().tolist() == [0, 2, 63, 64]
