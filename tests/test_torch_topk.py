"""freud_tpu_torch's TopK kernels' plain versions against freud_tpu's Pallas
kernels, run as the JAX package's own tests run them on the CPU (interpret
mode), on the same seeded numpy inputs.

Tolerances: thresholds and ``fired`` bit for bit (both packages select
exactly, or run the same float bisection); the fused forward's ``acts``
equal with at most 1 bf16 ulp on fewer than 1e-3 of entries, its selection
equal wherever the acts are, its decodes within 2e-2 of max |ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freud_tpu.ops.topk_fused import topk_sae_forward as jax_fused
from freud_tpu.ops.topk_threshold import topk_thresholds_fired as jax_thresholds
from freud_tpu_torch.ops.topk_fused import topk_sae_forward, topk_sae_forward_plain
from freud_tpu_torch.ops.topk_threshold import (
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
