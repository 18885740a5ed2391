"""The TopK backward's passes (``freud_tpu_torch/ops/topk_backward.py``) on
the CPU: their plain versions against the expressions
``models/sae/topk.py::_FusedLosses.backward`` ran before them, bit for bit,
on seeded inputs with the edge rows (a silent row, ties at both thresholds,
rows without a dead latent, a wholly dead dictionary); the wrappers take
the plain versions for CPU tensors; and ``W_dec``'s stacked product of
depth 2M against the two products and the add it replaced, within f32
rounding. The kernels themselves are held to the plain versions on a card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from freud_tpu_torch.models.sae.topk import _mm
from freud_tpu_torch.ops.topk_backward import (
    topk_masked_pair,
    topk_masked_pair_plain,
    topk_route,
    topk_route_plain,
)

BF16, F32 = torch.bfloat16, torch.float32


def _inputs(dtype, m=203, n=96, dead_kind="some", seed=3):
    """acts (M, n) ≥ 0, thresholds (M, 1) f32 that equal an entry of their
    row, dead flags (n,) f32 and [d1; d2] (2M, n) with negative zeros."""
    rng = np.random.default_rng(seed)
    a = np.maximum(rng.standard_normal((m, n)), 0).astype(np.float32)
    a[1] = 0.0  # silent: t_main 0
    a[2] = 0.25  # tied across the row
    acts = torch.from_numpy(a).to(dtype)
    dead = {"some": rng.random(n) < 0.4, "none": np.zeros(n, bool),
            "all": np.ones(n, bool)}[dead_kind]
    dead = torch.from_numpy(dead)
    af = acts.float()
    t_main = af.topk(8, dim=1).values[:, -1:].contiguous()
    if dead.any():
        masked = torch.where(dead, af, float("-inf"))
        t_aux = masked.topk(min(24, int(dead.sum())), dim=1).values[:, -1:].contiguous()
        t_aux[5::7] = float("inf")  # rows without a dead latent
    else:
        t_aux = torch.full((m, 1), float("inf"))
    d = torch.from_numpy(rng.standard_normal((2 * m, n)).astype(np.float32)).to(dtype)
    d[::3, ::5] = -0.0
    return acts, t_main, t_aux, dead.float(), d


def _before(acts, t_main, t_aux, dead_f, d):
    """The backward's (M, n_dict) expressions as they were before the passes
    (dense_main, dense_aux, d_acts, db_enc), ``d1``/``d2`` given."""
    m = acts.shape[0]
    d1, d2 = d[:m], d[m:]
    zero = torch.zeros((), dtype=acts.dtype, device=acts.device)
    keep_main = acts >= t_main
    keep_aux = (acts >= t_aux) & (dead_f > 0)
    dense_main = torch.where(keep_main, acts, zero)
    dense_aux = torch.where(keep_aux, acts, zero)
    ct = d1.dtype
    live = acts > 0
    zct = torch.zeros((), dtype=ct, device=acts.device)
    d_acts = (torch.where(keep_main & live, d1, zct)
              + torch.where(keep_aux & live, d2, zct))
    db_enc = torch.sum(d_acts, dim=0, dtype=torch.float32)
    return dense_main, dense_aux, d_acts, db_enc


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


CASES = [(dtype, dead) for dtype in (BF16, F32) for dead in ("some", "none", "all")]


@pytest.mark.parametrize("dtype,dead_kind", CASES)
def test_plain_passes_equal_the_backward_before_them(dtype, dead_kind):
    acts, t_main, t_aux, dead_f, d = _inputs(dtype, dead_kind=dead_kind)
    dense_main, dense_aux, d_acts, db_enc = _before(acts, t_main, t_aux, dead_f, d)
    pair = topk_masked_pair_plain(acts, t_main, t_aux, dead_f)
    got_d_acts, got_db = topk_route_plain(d, acts, t_main, t_aux, dead_f)
    m = acts.shape[0]
    assert torch.equal(_bits(pair[:m]), _bits(dense_main))
    assert torch.equal(_bits(pair[m:]), _bits(dense_aux))
    assert torch.equal(_bits(got_d_acts), _bits(d_acts))
    assert torch.equal(_bits(got_db), _bits(db_enc))
    # the edge rows as the masks read them: a silent row selects all its
    # zeros and routes nothing; ties at t_main are kept
    assert float(t_main[1]) == 0.0 and not got_d_acts[1].any()
    assert ((acts.float() >= t_main).sum(dim=1) > 8).any()
    assert bool(pair[m:].any()) == (dead_kind != "none")


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_wrappers_take_the_plain_versions_on_the_cpu(dtype):
    acts, t_main, t_aux, dead_f, d = _inputs(dtype)
    before = (topk_masked_pair.launches, topk_route.launches,
              topk_masked_pair.captured, topk_route.captured)
    pair = topk_masked_pair(acts, t_main, t_aux, dead_f)
    d_acts, db_enc = topk_route(d, acts, t_main, t_aux, dead_f)
    assert (topk_masked_pair.launches, topk_route.launches,
            topk_masked_pair.captured, topk_route.captured) == before
    assert torch.equal(_bits(pair), _bits(topk_masked_pair_plain(acts, t_main, t_aux, dead_f)))
    want = topk_route_plain(d, acts, t_main, t_aux, dead_f)
    assert torch.equal(_bits(d_acts), _bits(want[0]))
    assert torch.equal(_bits(db_enc), _bits(want[1]))


@pytest.mark.parametrize("bf16", [True, False])
def test_stacked_dW_dec_product_equals_the_two_it_replaced(bf16):
    """[dense_main; dense_aux]ᵀ · [g_main; g_aux] (one product of depth 2M)
    against dense_mainᵀ · g_main + dense_auxᵀ · g_aux, both within the f32
    rounding of a depth-2M sum of the exact product of their (bf16-rounded
    when ``bf16``) operands."""
    dtype = BF16 if bf16 else F32
    acts, t_main, t_aux, dead_f, _ = _inputs(dtype, m=301, n=64)
    m = acts.shape[0]
    rng = np.random.default_rng(4)
    g = torch.from_numpy(rng.standard_normal((2 * m, 24)).astype(np.float32))
    pair = topk_masked_pair(acts, t_main, t_aux, dead_f)
    stacked = _mm(pair.T, g, bf16)
    two = _mm(pair[:m].T, g[:m], bf16) + _mm(pair[m:].T, g[m:], bf16)
    a64 = pair.to(dtype).double()
    g64 = (g.to(BF16) if bf16 else g).double()
    exact = a64.T @ g64
    bound = (2 * m + 1) * 2.0 ** -24 * (a64.abs().T @ g64.abs())
    assert ((stacked.double() - exact).abs() <= bound).all()
    assert ((two.double() - exact).abs() <= bound).all()
    assert stacked.dtype == torch.float32 and stacked.shape == (64, 24)
    assert pair[m:].any() and (stacked != 0).any()
