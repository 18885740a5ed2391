"""The SAE encode's indexed top-k (``ops/topk_indexed``) on the CPU: the
wrapper's dispatch (a CPU tensor takes the plain stable sort, and
``select_topk`` and ``encode`` are what they were), the CPU sort's order on
the rows where it is subtle (ties to the lower column, -0.0 equal to +0.0,
NaN of either sign above +inf; on the card ``torch.sort`` orders NaNs by
their bits instead, which the kernel follows), the segment rule, the
argument checks, and ``_global_topk``'s merge across dictionary shards.
The kernel itself is held against the same plain version on the card
(tests/test_torch_cuda.py)."""

import types

import numpy as np
import pytest
import torch

from freud_tpu_torch.models.sae import topk as ttopk
from freud_tpu_torch.models.sae.config import TopKAutoEncoderConfig
from freud_tpu_torch.ops import topk_indexed as ti
from freud_tpu_torch.parallel import mesh as mesh_lib

NAN = float("nan")
INF = float("inf")


def _sorted(latents, k):
    """What ``select_topk`` computed before the kernel: a stable descending
    sort cut to k."""
    vals, idx = torch.sort(latents, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _edge_rows(n=48, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.maximum(rng.standard_normal((8, n)), 0).astype(np.float32)
    rows[0] = 0.0                       # all zeros: the columns decide
    rows[1] = 0.0                       # -0.0 among +0.0, fewer than k positives
    rows[1, ::3] = -0.0
    rows[1, 5] = 2.0
    rows[2, [3, 9, 30]] = INF           # +inf above every finite value
    rows[3, [4, 7]] = NAN               # NaN of either sign above +inf
    rows[3, 11] = -NAN
    rows[3, 2] = INF
    rows[4, :] = 1.5                    # every value tied at the k-th
    rows[5, ::2] = 0.25                 # many exact ties at the k-th value
    rows[6] = -rows[6]                  # non-positive: what a row without ReLU holds
    return torch.from_numpy(rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 5, 16, 32])
def test_cpu_tensor_takes_the_plain_sort(dtype, k):
    rows = _edge_rows().to(dtype)
    before = (ti.topk_indexed.launches, ti.topk_indexed.captured)
    vals, idx = ti.topk_indexed(rows, k)
    want_v, want_i = _sorted(rows, k)
    assert idx.dtype == torch.int64 and vals.dtype == dtype
    assert torch.equal(idx, want_i)
    assert torch.equal(_bits(vals), _bits(want_v))
    assert (ti.topk_indexed.launches, ti.topk_indexed.captured) == before


def test_the_sorts_order_on_subtle_rows():
    rows = _edge_rows()
    vals, idx = ti.topk_indexed_plain(rows, 6)
    assert idx[0].tolist() == [0, 1, 2, 3, 4, 5]       # zeros by column
    assert idx[1].tolist() == [5, 0, 1, 2, 3, 4]       # -0.0 ties +0.0
    assert _bits(vals[1, 1:2]).item() == _bits(torch.tensor([-0.0])).item()
    assert idx[3, :3].tolist() == [4, 7, 11] and idx[3, 3].item() == 2  # NaNs, then +inf
    assert torch.isnan(vals[3, :3]).all()
    assert idx[4].tolist() == [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("shape", [(7, 40), (2, 3, 40), (40,)])
def test_select_topk_and_encode_unchanged_on_the_cpu(shape):
    gen = torch.Generator().manual_seed(1)
    lat = torch.relu(torch.randn(shape, generator=gen))
    got = ttopk.select_topk(lat, 8)
    want_v, want_i = _sorted(lat, 8)
    assert torch.equal(got.top_indices, want_i) and torch.equal(got.top_acts, want_v)
    cfg = TopKAutoEncoderConfig(k=8, n_dict_components=40)
    params = ttopk.init_topk(10, cfg, seed=2)
    with torch.no_grad():
        params.encoder_bias.copy_(torch.randn(40, generator=gen) * 0.1)
        x = torch.randn((*shape[:-1], 10), generator=gen)
        enc = ttopk.encode(params, x, cfg)
        want = _sorted(ttopk.pre_acts(params, x), 8)
    assert torch.equal(enc.top_indices, want[1])
    assert torch.equal(_bits(enc.top_acts), _bits(want[0]))


def test_fused_bias_is_pre_acts_then_the_sort():
    gen = torch.Generator().manual_seed(3)
    z = torch.randn((9, 64), generator=gen)
    z[0, :] = -0.0
    z[1, 3] = NAN
    b = torch.randn(64, generator=gen) * 0.5
    b[0] = -0.0
    vals, idx = ti.topk_indexed(z, 32, bias=b)
    want_v, want_i = _sorted(torch.relu(z + b), 32)
    assert torch.equal(idx, want_i)
    assert torch.equal(_bits(vals), _bits(want_v))


@pytest.mark.parametrize("n,dtype,parts", [
    (20_480, torch.float32, 1), (57_344, torch.float32, 2), (57_344, torch.bfloat16, 1),
    (1_001, torch.float32, 1), (28_672, torch.float32, 1), (60_000, torch.float32, 3),
    (49_152, torch.float32, 2), (114_688, torch.bfloat16, 2), (1, torch.bfloat16, 1),
])
def test_segment_count_comes_from_the_width(n, dtype, parts):
    got = ti.segments(n, dtype)
    assert got == parts
    assert n % got == 0 and n // got <= ti.MAX_N[dtype]


def test_a_width_without_equal_segments_raises():
    with pytest.raises(ValueError, match="segments"):
        ti.segments(1_000_003, torch.float32)  # prime, wider than a segment


@pytest.mark.parametrize("case,err", [
    ("k_above_n", ValueError), ("k_above_256", ValueError), ("k_zero", ValueError),
    ("float16", TypeError), ("int32", TypeError), ("rank0", ValueError),
    ("bias_bf16", TypeError), ("bias_shape", ValueError), ("bias_f64", TypeError),
])
def test_argument_checks_raise(case, err):
    x = torch.zeros((4, 300))
    kw = {}
    k = 8
    if case == "k_above_n":
        x, k = torch.zeros((4, 6)), 7
    elif case == "k_above_256":
        k = 257
    elif case == "k_zero":
        k = 0
    elif case == "float16":
        x = x.half()
    elif case == "int32":
        x = x.int()
    elif case == "rank0":
        x, k = torch.tensor(1.0), 1
    elif case == "bias_bf16":
        x, kw = x.bfloat16(), {"bias": torch.zeros(300)}
    elif case == "bias_shape":
        kw = {"bias": torch.zeros(299)}
    elif case == "bias_f64":
        kw = {"bias": torch.zeros(300, dtype=torch.float64)}
    with pytest.raises(err):
        ti.topk_indexed(x, k, **kw)


def test_k_of_256_is_taken():
    x = torch.relu(torch.randn((3, 600), generator=torch.Generator().manual_seed(4)))
    vals, idx = ti.topk_indexed(x, 256)
    assert torch.equal(idx, _sorted(x, 256)[1])


@pytest.mark.parametrize("k", [4, 16])
def test_global_topk_merges_shards_in_the_sorts_order(monkeypatch, k):
    """Two model ranks' local selections gathered in rank order and merged:
    the whole row's ``select_topk``, ties (zeros, a tied value across the
    shards' boundary) to the lower global column."""
    rows = _edge_rows(n=32, seed=5)[[0, 1, 4, 5, 7]]
    rows[4, 14:18] = 3.0  # a tie that straddles the two shards
    halves = rows.split(16, dim=-1)
    locals_ = [ttopk.select_topk(h, k) for h in halves]
    gathered = iter([torch.stack([loc.top_acts for loc in locals_]),
                     torch.stack([loc.top_indices + 16 * r for r, loc in enumerate(locals_)])])
    monkeypatch.setattr(mesh_lib, "model_sharded", lambda mesh: mesh is not None)
    monkeypatch.setattr(mesh_lib, "model_all_gather", lambda mesh, t: next(gathered))
    mesh = types.SimpleNamespace(model_rank=0, model_size=2)
    got = ttopk._global_topk(halves[0], k, mesh)
    want = ttopk.select_topk(rows, k)
    assert torch.equal(got.top_indices, want.top_indices)
    assert torch.equal(got.top_acts, want.top_acts)
    assert torch.equal(ttopk._global_topk(rows, k, None).top_indices, want.top_indices)
