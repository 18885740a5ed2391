"""freud_tpu_torch's CUDA kernels against their plain PyTorch versions, on a
card. Every test here is marked ``cuda`` and skips without one (a CUDA
kernel has no CPU mode); the CPU differential tests are the other
``test_torch_*.py`` files. This file imports no JAX, so it also runs on a
card machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: log-mel — the bounds of tests/test_mel_pallas.py (max |Δ| <
2e-3, share of |Δ| > 3e-4 below 1e-5) against the plain path, and the
recipe gate of ``freud_tpu_torch/ops/mel.py`` (log10 units: max |Δ| <
1e-3, share of |Δ| > 1e-5 below 1e-3) against its recipe with exact sums;
both attention kernels — max |Δ| / max |ref| < 2e-2 against the f32 plain
version, the bf16-product bound of tests/test_attention_kernel.py, and the
fused kernel within
``ATTN_BF16_GATE`` of the plain version rounded where the contract rounds;
an encoder block on the card within 5e-2 of max of the CPU; TopK
thresholds and fired — bit for bit against the plain version on the same
input; the fused forward — acts differ on fewer than 1e-3 of entries, by at
most one bf16 ulp of the pre-activation (the card's f32 sums round it
either way), selection bit-equal to the plain selection on the kernel's own
acts, decodes within 1e-3 of max; one TopK training backward on the card
within 3e-2 of max of the CPU's gradients; the selection across dictionary
shards — candidates equal to the plain version's as key multisets with the
header exact, thresholds and fired bit for bit against the plain versions
and kernel #3 on the whole latent; the TopK backward's passes — dense_* and
d_acts bit for bit against the plain versions, db_enc within the f32
rounding bound of its two-level sum; the SAE encode's indexed top-k —
values and indices bit for bit against the stable ``torch.sort`` on the
card (and the CPU's sort, off rows with NaN, which it orders otherwise),
with the fused bias and ReLU against ``pre_acts``' add and ReLU; the 3xTF32
product — its largest error against a float64 product over the output's
RMS at most 2× cuBLAS f32's (TF32 off) and 30× under one TF32 product's at
the cells' shapes, two launches bit for bit, ragged shapes within the
plain recipe's bound."""

import copy
import time

import numpy as np
import pytest
import torch

from freud_tpu_torch import _native
from freud_tpu_torch.audio.mel import log_mel_spectrogram
from freud_tpu_torch.models.whisper import WhisperDims, WhisperRuntime
from freud_tpu_torch.ops.attention import (
    ATTN_BF16_GATE,
    fused_qkv_attention,
    fused_qkv_attention_plain,
    whisper_attention,
    whisper_attention_plain,
)
from freud_tpu_torch.ops.mel import (
    RECIPE_MAX,
    RECIPE_SHARE,
    log_mel_spectrogram_cuda,
    log_mel_spectrogram_recipe,
    recipe_gap,
)
from freud_tpu_torch.ops import topk_sharded as ts
from freud_tpu_torch.ops.topk_fused import topk_sae_forward, topk_sae_forward_plain
from freud_tpu_torch.ops.topk_threshold import (
    topk_thresholds_fired,
    topk_thresholds_fired_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_matches_plain(cuda, n_mels):
    rng = np.random.default_rng(5)
    audio = torch.from_numpy(
        (rng.standard_normal((4, 480000)) * 0.1).astype(np.float32)).to(cuda)
    audio[1, 1000:] = 0.0  # a mostly silent clip: the floor clamps most bins
    before = log_mel_spectrogram_cuda.launches
    got = log_mel_spectrogram_cuda(audio, n_mels)
    torch.cuda.synchronize()
    assert log_mel_spectrogram_cuda.launches == before + 1
    diff = (got - log_mel_spectrogram(audio, n_mels)).abs()
    assert diff.max().item() < 2e-3
    assert (diff > 3e-4).float().mean().item() < 1e-5
    with pytest.raises(ValueError):
        log_mel_spectrogram_cuda(audio[:, :1000].contiguous(), n_mels)
    with pytest.raises(TypeError):
        log_mel_spectrogram_cuda(audio.double(), n_mels)


def _smoke_clips(cuda, silent: bool) -> torch.Tensor:
    """chip_smoke.py's 32 seeded noise clips, all silent after 1000 samples
    when ``silent``."""
    gen = torch.Generator().manual_seed(0)
    audio = (torch.randn((32, 480000), generator=gen) * 0.1).to(cuda)
    if silent:
        audio[:, 1000:] = 0.0
    return audio


@pytest.mark.parametrize("silent", [False, True])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_matches_recipe(cuda, n_mels, silent):
    """The kernel against its own recipe (three bf16 limb products, exact
    sums) within the recipe gate, on chip_smoke.py's batch of 32 seeded
    clips; ``silent``: every clip silent after 1000 samples, where on clip
    15 the recipe itself is 2.4e-3 off the f64 log-mel, above the plain
    path's 2e-3 gate (tests/test_torch_mel.py pins that reading)."""
    audio = _smoke_clips(cuda, silent)
    got = log_mel_spectrogram_cuda(audio, n_mels)
    max_err, share = recipe_gap(got, log_mel_spectrogram_recipe(audio, n_mels))
    assert max_err < RECIPE_MAX and share < RECIPE_SHARE, (max_err, share)


@pytest.mark.parametrize("s", [1500, 77])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(cuda, s, x_dtype):
    rng = np.random.default_rng(6)
    d = 384
    x = torch.from_numpy(rng.standard_normal((2, s, d)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32))
          for _ in range(3)]
    bq, bv = (torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32))
              for _ in range(2))
    x = x.to(cuda, x_dtype)
    wq, wk, wv, bq, bv = (t.to(cuda) for t in (*ws, bq, bv))
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(x, wq, bq, wk, wv, bv, 6)
    torch.cuda.synchronize()
    assert fused_qkv_attention.launches == before + 1
    assert got.dtype == x_dtype
    want = fused_qkv_attention_plain(x.float(), wq, bq, wk, wv, bv, 6)
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() < 2e-2
    with pytest.raises(ValueError):  # head_dim 32 is not a kernel shape
        fused_qkv_attention(x, wq, bq, wk, wv, bv, 12)


@pytest.mark.parametrize("s", [1500, 77, 1])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_bf16_plain(cuda, s, x_dtype):
    """The fused kernel (wgmma projection, then the attention phase) against
    the bf16-rounded plain version, with nn.Linear-style (out, in) weights
    passed transposed as the model passes them; two launches bit-equal."""
    rng = np.random.default_rng(15)
    d = 384
    x = torch.from_numpy(rng.standard_normal((3, s, d)).astype(np.float32)).to(cuda, x_dtype)
    lin = [torch.from_numpy((rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32)).to(cuda)
           for _ in range(3)]
    bq, bv = (torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32)).to(cuda)
              for _ in range(2))
    args = (x, lin[0].t(), bq, lin[1].t(), lin[2].t(), bv, 6)
    got = fused_qkv_attention(*args)
    again = fused_qkv_attention(*args)
    want = fused_qkv_attention_plain(x.float(), *args[1:], matmul_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = (got.float() - want).abs().max() / want.abs().max()
    assert err.item() < ATTN_BF16_GATE[x_dtype]


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_kernel_ragged_batch_bit_equal(cuda, n_mels):
    """33 clips (not a multiple of anything in the design), one of them
    silent after 1000 samples: the plain path's gate, and two launches
    agree bit for bit (no atomics in the sums)."""
    rng = np.random.default_rng(16)
    audio = torch.from_numpy(
        (rng.standard_normal((33, 480000)) * 0.1).astype(np.float32)).to(cuda)
    audio[7, 1000:] = 0.0
    got = log_mel_spectrogram_cuda(audio, n_mels)
    again = log_mel_spectrogram_cuda(audio, n_mels)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    diff = (got - log_mel_spectrogram(audio, n_mels)).abs()
    assert diff.max().item() < 2e-3
    assert (diff > 3e-4).float().mean().item() < 1e-5


@pytest.mark.parametrize("stable", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 777, 1500])
def test_whisper_attention_kernel_matches_plain(cuda, s, dtype, stable):
    """(b, h, s, 64) head views of (b, s, d) projections, as the encoder
    passes them, at s around the 128-row query and key tiles; the output is
    a (b, h, s, 64) view of (b, s, h, 64) memory. Unit-normal q, k, v give
    scores of std 1, which stable=False takes without overflow."""
    rng = np.random.default_rng(12)
    b, h = 2, 20
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * 64)).astype(np.float32))
               .to(cuda, dtype).view(b, s, h, 64).transpose(1, 2) for _ in range(3))
    before = whisper_attention.launches
    got = whisper_attention(q, k, v, stable=stable)
    torch.cuda.synchronize()
    assert whisper_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h, s, 64)
    assert got.transpose(1, 2).is_contiguous()  # (b, s, h, 64) memory
    want = whisper_attention_plain(q, k, v)
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err.item() < 2e-2
    with pytest.raises(ValueError):  # the kernel computes in bf16 only
        whisper_attention(q, k, v, matmul_dtype=torch.float32)
    with pytest.raises(ValueError):  # head_dim 32 is not a kernel shape
        whisper_attention(*(t[..., :32] for t in (q, k, v)))


def test_wide_encoder_on_card_matches_cpu(cuda):
    """A medium-width block (d 1024, 16 heads) takes the whisper_attention
    kernel on the card, never the fused one, and matches the CPU's plain
    f32 path within 5e-2 of max (bf16 attention products)."""
    from freud_tpu_torch.models.whisper import init_encoder

    dims = WhisperDims(n_mels=80, n_audio_ctx=1500, n_audio_state=1024,
                       n_audio_head=16, n_audio_layer=1, n_vocab=51865,
                       n_text_ctx=448, n_text_state=1024, n_text_head=16,
                       n_text_layer=1)
    enc = init_encoder(dims, seed=3)
    mels = torch.from_numpy(
        np.random.default_rng(13).standard_normal((2, 80, 3000)).astype(np.float32) * 0.5)
    with torch.inference_mode():
        want = enc(mels, capture=("encoder.blocks.0",))[1]["encoder.blocks.0"]
        enc = enc.to(cuda)
        before = (whisper_attention.launches, fused_qkv_attention.launches)
        got = enc(mels.to(cuda), capture=("encoder.blocks.0",))[1]["encoder.blocks.0"]
        torch.cuda.synchronize()
    assert (whisper_attention.launches, fused_qkv_attention.launches) == (
        before[0] + 1, before[1])
    got = got.cpu()
    assert got.shape == want.shape == (2, 1500, 1024)
    assert ((got - want).abs().max() / want.abs().max()).item() < 5e-2


def test_runtime_on_card_matches_cpu(cuda):
    """test:tiny block 1 on the card against the CPU plain path (bf16
    attention products in blocks 0-1: within 5e-2 of the CPU max)."""
    rng = np.random.default_rng(7)
    mels = torch.from_numpy(rng.standard_normal((2, 80, 3000)).astype(np.float32) * 0.5)
    card = WhisperRuntime("test:tiny", "encoder.blocks.1", device=cuda)
    cpu = WhisperRuntime("test:tiny", "encoder.blocks.1", device="cpu")
    got = card.activations(mels.to(cuda)).cpu()
    want = cpu.activations(mels)
    assert got.shape == want.shape == (2, 1500, 384)
    assert ((got - want).abs().max() / want.abs().max()).item() < 5e-2


def _topk_rows(cuda, m=3000, n=1024, seed=8):
    rng = np.random.default_rng(seed)
    a = np.maximum(rng.standard_normal((m, n)), 0).astype(np.float32)
    if m > 3:
        a[1] = 0.0  # silent row
        a[2] = 0.25  # one tie across the row
        a[3] = 0.0
        a[3, :5] = 1.0  # fewer positives than k
    return torch.from_numpy(a).to(cuda)


BF16, F32 = torch.bfloat16, torch.float32
# (dtype, signed, dead share, m, n, rows of -inf): the main-path types at
# (3000, 1024), then the edges of the selection core — a width that is not
# a multiple of 8 (rows load without the ring), n_dict 20,480 on the exact
# path, 2^15 + 8 bf16 columns on the float path, one row, a row count that
# is not a multiple of the grid, rows all -inf with no dead column
THRESHOLD_CASES = [
    *[(dtype, signed, share, 3000, 1024, False)
      for dtype, signed in ((BF16, False), (F32, False), (BF16, True))
      for share in (0.0, 0.01, 0.4)],
    (BF16, False, 0.4, 3000, 1001, False),
    (F32, False, 0.4, 500, 1001, False),
    (BF16, False, 0.94, 600, 20480, False),
    (BF16, False, 0.4, 300, 2 ** 15 + 8, False),
    (BF16, False, 0.4, 1, 1024, False),
    (F32, False, 0.4, 1, 1024, False),
    (F32, False, 0.4, 1237, 1024, False),
    (F32, False, 0.0, 3000, 1024, True),
    (BF16, True, 0.0, 3000, 1024, True),
]


@pytest.mark.parametrize("dtype,signed,dead_share,m,n,neg_inf", THRESHOLD_CASES)
def test_topk_thresholds_kernel_bit_equal(cuda, dtype, signed, dead_share, m, n, neg_inf):
    a = _topk_rows(cuda, m, n)
    if neg_inf:  # rows all -inf, and a row of -inf but for 5 entries
        a[4:8] = float("-inf")
        a[8, 5:] = float("-inf")
    acts = (a - 0.5 if signed else a).to(dtype)
    dead = torch.from_numpy(np.random.default_rng(9).random(n) < dead_share).to(cuda)
    before = topk_thresholds_fired.launches
    got = topk_thresholds_fired(acts, dead, 32, 192, k_multi=128, signed=signed)
    again = topk_thresholds_fired(acts, dead, 32, 192, k_multi=128, signed=signed)
    want = topk_thresholds_fired_plain(acts, dead, 32, 192, k_multi=128, signed=signed)
    torch.cuda.synchronize()
    assert topk_thresholds_fired.launches == before + 2
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(g, g2)
    if dead_share == 0.0:
        assert torch.isinf(got[1]).all()


SHARD_K, SHARD_K_AUX, SHARD_K_MULTI = 32, 192, 128
SHARD_KINDS = {"exact": ts.EXACT, "bf16": ts.BF16, "f32": ts.F32}


def _shard_inputs(cuda, kind, n_s, p, dead_kind, m=2000, seed=12):
    """p shards of n_s columns with the edge rows (silent, a tie across the
    shard boundaries, one value throughout; on the float kinds a row of
    negative values with -inf), the dead mask of test_torch_model_axis's
    case, and whether the bf16 float path needs ``signed``."""
    rng = np.random.default_rng(seed)
    n = n_s * p
    a = np.maximum(rng.standard_normal((m, n)), 0).astype(np.float32)
    a[1] = 0.0
    a[2, n // 2 - 3:n // 2 + 3] = 2.5
    a[3] = 0.75
    if kind != ts.EXACT:
        a[4] = -np.abs(a[4]) - 0.25
        a[4, ::7] = -np.inf
    if dead_kind == "few":  # fewer dead than k_aux in the whole row
        dead = np.zeros(n, bool)
        dead[rng.choice(n, min(n, SHARD_K_AUX // 2), replace=False)] = True
    else:
        dead = rng.random(n) < (0.4 if dead_kind != "none" else 0.0)
        if dead_kind == "first_shard_alive":
            dead[:n_s] = False
    acts = torch.from_numpy(a).to(cuda).to(torch.float32 if kind == ts.F32 else torch.bfloat16)
    # a bf16 latent narrower than 2^15 takes the float path only when signed
    return acts, torch.from_numpy(dead).to(cuda), kind == ts.BF16


def _same_candidates(got, want):
    """Each region a multiset of keys (the order within it is the kernel's
    own), the header exact."""
    c_main = got.shape[1] - SHARD_K_AUX - ts.HEADER
    for lo, hi in ((0, c_main), (c_main, c_main + SHARD_K_AUX)):
        g = torch.sort(got[:, lo:hi].to(torch.int64) & 0xFFFFFFFF, dim=1).values
        w = torch.sort(want[:, lo:hi].to(torch.int64) & 0xFFFFFFFF, dim=1).values
        assert torch.equal(g, w)
    assert torch.equal(got[:, -ts.HEADER:], want[:, -ts.HEADER:])


def _check_sharded_selection(acts, dead, kind, p, signed, whole_fn):
    n = acts.shape[1]
    s = n // p
    shards = [acts[:, i * s:(i + 1) * s].contiguous() for i in range(p)]
    dead_s = [dead[i * s:(i + 1) * s] for i in range(p)]
    k_sel = max(SHARD_K, SHARD_K_MULTI)
    before = (ts.shard_candidates.launches, ts.combine_shard_thresholds.launches)
    cands = [ts.shard_candidates(x, d, k_sel, SHARD_K_AUX, kind) for x, d in zip(shards, dead_s)]
    plain = [ts.shard_candidates_plain(x, d, k_sel, SHARD_K_AUX, kind)
             for x, d in zip(shards, dead_s)]
    args = (n, SHARD_K, SHARD_K_AUX, SHARD_K_MULTI, kind)
    got = [ts.combine_shard_thresholds(torch.stack(cands), x, *args) for x in shards]
    want = [ts.combine_shard_thresholds_plain(torch.stack(plain), x, *args) for x in shards]
    whole = whole_fn(acts, dead, SHARD_K, SHARD_K_AUX, k_multi=SHARD_K_MULTI, signed=signed)
    torch.cuda.synchronize()
    assert (ts.shard_candidates.launches, ts.combine_shard_thresholds.launches) == (
        before[0] + p, before[1] + p)
    for c, pc in zip(cands, plain):
        _same_candidates(c, pc)
    for i, (g, w) in enumerate(zip(got, want)):
        for j in range(3):
            assert torch.equal(g[j], w[j]) and torch.equal(g[j], whole[j]), j
        assert torch.equal(g[3], w[3]) and torch.equal(g[3], whole[3][i * s:(i + 1) * s])


@pytest.mark.parametrize("n_s", [1024, 1001, 100])  # aligned, not 16-byte rows, < k_sel
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dead_kind", ["many", "few", "none", "first_shard_alive"])
@pytest.mark.parametrize("kind", list(SHARD_KINDS))
def test_sharded_selection_launches_match_plain(cuda, kind, dead_kind, p, n_s):
    """The candidates and combine launches of csrc/topk_sharded.cu against
    their plain versions and kernel #3 on the whole latent."""
    acts, dead, signed = _shard_inputs(cuda, SHARD_KINDS[kind], n_s, p, dead_kind)
    _check_sharded_selection(acts, dead, SHARD_KINDS[kind], p, signed, topk_thresholds_fired)


def test_sharded_selection_takes_the_widest_f32_shard(cuda):
    """An f32 shard of 52,379 columns (wider than kernel #3's 49,152 f32
    columns: held to its plain version on the whole latent); one more
    column than the launch takes raises."""
    n_s = 52379
    acts, dead, _ = _shard_inputs(cuda, ts.F32, n_s, 2, "many", m=64)
    _check_sharded_selection(acts, dead, ts.F32, 2, False, topk_thresholds_fired_plain)
    widest = _native.limit("topk_sharded", "freud_shard_max_local")
    assert widest >= n_s
    with pytest.raises(ValueError):
        ts.shard_candidates(torch.zeros((4, widest + 1), device=cuda),
                            torch.zeros((widest + 1,), dtype=torch.bool, device=cuda),
                            SHARD_K, SHARD_K_AUX, ts.F32)


@pytest.mark.parametrize("m,dead_share", [(3000, 0.3), (77, 0.01), (77, 0.0)])
def test_topk_fused_kernel_matches_plain(cuda, m, dead_share):
    rng = np.random.default_rng(10)
    d, n = 384, 1024
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    w_enc = torch.from_numpy((rng.uniform(-1, 1, (n, d)) / np.sqrt(d)).astype(np.float32)).to(cuda)
    b_enc = -torch.from_numpy((rng.random(n) * 0.1).astype(np.float32)).to(cuda)
    b_dec = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32)).to(cuda)
    w_dec = torch.nn.functional.normalize(w_enc, dim=1)
    x[5] = b_dec  # a silent row
    dead = torch.from_numpy(rng.random(n) < dead_share).to(cuda)
    before = topk_sae_forward.launches
    got = topk_sae_forward(x, w_enc.T, b_enc, b_dec, w_dec, dead.float(), 32, 192)
    want = topk_sae_forward_plain(x, w_enc.T, b_enc, b_dec, w_dec, dead.float(), 32, 192)
    torch.cuda.synchronize()
    assert topk_sae_forward.launches == before + 1
    acts = got[0]
    z = (x - b_dec).to(torch.bfloat16).float() @ w_enc.to(torch.bfloat16).float().T
    _, e = torch.frexp(z.to(torch.bfloat16).float())
    ulp = torch.ldexp(torch.ones_like(z), e - 8) + want[0].float().abs() * 2.0 ** -7
    diff = (acts.float() - want[0].float()).abs()
    assert (diff > 0).float().mean().item() < 1e-3
    assert (diff <= ulp).all()
    tm, ta, _, fired = topk_thresholds_fired_plain(acts, dead, 32, 192)
    assert torch.equal(got[3], tm) and torch.equal(got[4], ta) and torch.equal(got[5], fired)
    assert got[3][5].item() == 0.0 and not got[1][5].any()
    af = acts.float()
    w = w_dec.to(torch.bfloat16).float()
    y_main = torch.where(af >= tm, af, 0.0) @ w
    y_aux = torch.where((af >= ta) & dead, af, 0.0) @ w
    assert ((got[1] - y_main).abs().max() / y_main.abs().max()).item() < 1e-3
    assert ((got[2] - y_aux).abs().max()).item() <= 1e-3 * max(y_aux.abs().max().item(), 1e-30)
    with pytest.raises(ValueError):  # d_in % 32 != 0 is not a kernel shape
        topk_sae_forward(x[:, :100].contiguous(), w_enc[:, :100].T, b_enc, b_dec[:100],
                         w_dec[:, :100], dead.float(), 32, 192)


@pytest.mark.parametrize("m", [3000, 77])
def test_topk_encode_decode_launches_match_forward(cuda, m):
    """Kernel #4's encode and decode launches, as a split dictionary's step
    runs them: the encode's acts bit-equal to the whole forward's on the same
    columns, and the decode under the forward's thresholds bit-equal to its
    decodes (the same tiles in the same order); each call counts one."""
    from freud_tpu_torch.ops.topk_fused import topk_sae_decode, topk_sae_encode

    rng = np.random.default_rng(11)
    d, n = 384, 1024
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    w_enc = torch.from_numpy((rng.uniform(-1, 1, (n, d)) / np.sqrt(d)).astype(np.float32)).to(cuda)
    b_enc = -torch.from_numpy((rng.random(n) * 0.1).astype(np.float32)).to(cuda)
    b_dec = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32)).to(cuda)
    w_dec = torch.nn.functional.normalize(w_enc, dim=1)
    dead = torch.from_numpy(rng.random(n) < 0.3).to(cuda)
    whole = topk_sae_forward(x, w_enc.T, b_enc, b_dec, w_dec, dead.float(), 32, 192)
    before = (topk_sae_encode.launches, topk_sae_decode.launches)
    acts = topk_sae_encode(x, w_enc.T, b_enc, b_dec)
    y_main, y_aux = topk_sae_decode(acts, w_dec, dead.float(), whole[3], whole[4])
    torch.cuda.synchronize()
    assert (topk_sae_encode.launches, topk_sae_decode.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    assert torch.equal(acts, whole[0])
    assert torch.equal(y_main, whole[1]) and torch.equal(y_aux, whole[2])
    half = topk_sae_encode(x, w_enc[: n // 2].T, b_enc[: n // 2], b_dec)
    assert torch.equal(half, whole[0][:, : n // 2])


def test_topk_fused_kernel_large_geometry(cuda):
    """large_v1_audioset's geometry (d_in 1280, n_dict 20480, k 32, k_aux
    640, 94% of latents dead) with silent rows and ties at t_main: the same
    bounds, and two launches agree bit for bit."""
    rng = np.random.default_rng(14)
    m, d, n, k, k_aux = 2000, 1280, 20480, 32, 640
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(cuda)
    w_enc = torch.from_numpy((rng.uniform(-1, 1, (n, d)) / np.sqrt(d)).astype(np.float32)).to(cuda)
    b_enc = -torch.from_numpy((rng.random(n) * 0.1).astype(np.float32)).to(cuda)
    b_dec = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32)).to(cuda)
    w_dec = torch.nn.functional.normalize(w_enc, dim=1)
    x[3] = b_dec  # silent rows
    x[m - 1] = b_dec
    dead = torch.from_numpy(rng.random(n) < 0.94).to(cuda)
    args = (x, w_enc.T, b_enc, b_dec, w_dec, dead.float(), k, k_aux)
    got = topk_sae_forward(*args)
    again = topk_sae_forward(*args)
    want = topk_sae_forward_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    acts = got[0]
    diff = (acts.float() - want[0].float()).abs()
    assert (diff > 0).float().mean().item() < 1e-3
    tm, ta, _, fired = topk_thresholds_fired_plain(acts, dead, k, k_aux)
    assert torch.equal(got[3], tm) and torch.equal(got[4], ta) and torch.equal(got[5], fired)
    assert (got[3][[3, m - 1]] == 0).all() and not got[1][[3, m - 1]].any()
    af = acts.float()
    assert (((af >= tm).sum(dim=1) > k) & (tm[:, 0] > 0)).any()  # ties at t_main
    w = w_dec.to(torch.bfloat16).float()
    y_main = torch.where(af >= tm, af, 0.0) @ w
    y_aux = torch.where((af >= ta) & dead, af, 0.0) @ w
    assert ((got[1] - y_main).abs().max() / y_main.abs().max()).item() < 1e-3
    assert ((got[2] - y_aux).abs().max() / y_aux.abs().max()).item() < 1e-3


def test_topk_training_backward_on_card_matches_cpu(cuda):
    from freud_tpu_torch.models.sae import params_from_jax
    from freud_tpu_torch.models.sae import topk as topk_mod
    from freud_tpu_torch.models.sae.config import TopKAutoEncoderConfig

    rng = np.random.default_rng(11)
    d, n = 384, 2048
    w = rng.uniform(-1, 1, (n, d)).astype(np.float32) / np.sqrt(d)
    np_params = {"encoder_weight": w, "W_dec": w / np.linalg.norm(w, axis=1, keepdims=True),
                 "encoder_bias": np.zeros(n, np.float32),
                 "b_dec": (rng.standard_normal(d) * 0.01).astype(np.float32)}
    x = torch.from_numpy(rng.standard_normal((2, 300, d)).astype(np.float32))
    dead = torch.from_numpy(rng.random(n) < 0.3)
    cfg = TopKAutoEncoderConfig(n_dict_components=n, k=32, auxk_alpha=1 / 32)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        params = params_from_jax("topk", np_params, dev)
        terms, _ = topk_mod.training_losses(params, x.to(dev), cfg, dead.to(dev),
                                            matmul_dtype=torch.bfloat16)
        (terms["fvu"] + terms["auxk_loss"]).backward()
        grads[dev.type] = {k: p.grad.cpu() for k, p in params.named_parameters()}
    for k, g in grads["cpu"].items():
        assert ((grads["cuda"][k] - g).abs().max() / g.abs().max()).item() < 3e-2, k


# (dtype, rows, width, dead): the tiny recipe's width and the large one's,
# row counts that are not a multiple of the kernels' row group, a width that
# is not a multiple of 16 bytes (a split dictionary's shard), then no dead
# latent (t_aux +inf in every row) and a wholly dead dictionary
BACKWARD_CASES = [
    *[(dtype, m, n, "some") for dtype in (BF16, F32)
      for m, n in ((3001, 6144), (1237, 20480), (777, 1001))],
    *[(dtype, 3001, 6144, dead) for dtype in (BF16, F32) for dead in ("none", "all")],
]


def _backward_inputs(cuda, dtype, m, n, dead_kind, seed=15):
    """acts, thresholds and dead flags as the backward sees them, with a
    silent row (t_main 0), a row tied across, thresholds equal to an entry
    of their row (ties kept), rows without a dead latent (t_aux +inf), and
    [d1; d2] with negative zeros."""
    gen = torch.Generator(cuda).manual_seed(seed)
    acts = torch.relu(torch.randn((m, n), generator=gen, device=cuda)).to(dtype)
    acts[1] = 0.0
    acts[2] = 0.25
    dead = {"some": torch.rand((n,), generator=gen, device=cuda) < 0.4,
            "none": torch.zeros((n,), dtype=torch.bool, device=cuda),
            "all": torch.ones((n,), dtype=torch.bool, device=cuda)}[dead_kind]
    af = acts.float()
    t_main = af.topk(32, dim=1).values[:, -1:].contiguous()
    n_dead = int(dead.sum())
    if n_dead:
        masked = torch.where(dead, af, float("-inf"))
        t_aux = masked.topk(min(192, n_dead), dim=1).values[:, -1:].contiguous()
        t_aux[5::7] = float("inf")
    else:
        t_aux = torch.full((m, 1), float("inf"), device=cuda)
    d = torch.randn((2 * m, n), generator=gen, device=cuda).to(dtype)
    d[::3, ::5] = -0.0
    return acts, t_main, t_aux, dead.float(), d


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype,m,n,dead_kind", BACKWARD_CASES)
def test_topk_backward_passes_bit_equal_plain(cuda, dtype, m, n, dead_kind):
    """The backward's masked pair and route launches (csrc/topk_backward.cu)
    against their plain versions: dense_* and d_acts bit for bit, signs of
    zeros included; db_enc within the f32 rounding of its two-level sum
    (each row group's sum, then the groups in order) of the exact column
    sum, and the same bits from two launches; one count a call."""
    from freud_tpu_torch.ops.topk_backward import (
        GROUP_ROWS,
        topk_masked_pair,
        topk_masked_pair_plain,
        topk_route,
        topk_route_plain,
    )

    acts, t_main, t_aux, dead_f, d = _backward_inputs(cuda, dtype, m, n, dead_kind)
    before = (topk_masked_pair.launches, topk_route.launches)
    pair = topk_masked_pair(acts, t_main, t_aux, dead_f)
    pair_again = topk_masked_pair(acts, t_main, t_aux, dead_f)
    d_acts, db_enc = topk_route(d, acts, t_main, t_aux, dead_f)
    d_acts_again, db_enc_again = topk_route(d, acts, t_main, t_aux, dead_f)
    want_pair = topk_masked_pair_plain(acts, t_main, t_aux, dead_f)
    want_d_acts, want_db = topk_route_plain(d, acts, t_main, t_aux, dead_f)
    torch.cuda.synchronize()
    assert (topk_masked_pair.launches, topk_route.launches) == (before[0] + 2, before[1] + 2)
    assert pair.dtype == dtype and d_acts.dtype == dtype
    assert torch.equal(_bits(pair), _bits(want_pair))
    assert torch.equal(_bits(pair_again), _bits(pair))
    assert torch.equal(_bits(d_acts), _bits(want_d_acts))
    assert torch.equal(_bits(d_acts_again), _bits(d_acts))
    assert torch.equal(_bits(db_enc_again), _bits(db_enc))
    exact = want_d_acts.double().sum(dim=0)
    bound = (GROUP_ROWS + -(-m // GROUP_ROWS)) * 2.0 ** -24 * want_d_acts.double().abs().sum(0)
    assert ((db_enc.double() - exact).abs() <= bound).all()
    assert ((want_db.double() - exact).abs() <= bound).all()
    # the cases select something on both sides, and route something
    assert pair[:m].any() and d_acts.any()
    assert bool(pair[m:].any()) == (dead_kind != "none")


def test_train_chunk_replay_launches_each_backward_pass_once_a_step(cuda, tmp_path):
    """A replayed TopK chunk (tiny width, AuxK live) counts one launch of
    each backward pass a step."""
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache
    from freud_tpu_torch.ops.topk_backward import topk_masked_pair, topk_route
    from freud_tpu_torch.train.trainer import SAETrainer

    path, _ = _activation_store(tmp_path / "s")
    trainer = SAETrainer("topk", {"expansion_factor": 16, "k": 32, "auxk_alpha": 1 / 32,
                                  "dead_feature_threshold": 3000}, 384, optimizer="adam",
                         lr=1e-3, steps=50, device=cuda)
    with torch.no_grad():
        trainer.params.encoder_bias[::2] = -1e3
    cache = DeviceShuffleCache(path, "encoder.blocks.2", 12, refresh_files=0, device=cuda)
    try:
        trainer.train_chunk(cache, 4, 3)  # captured, then replayed
        before = (topk_masked_pair.launches, topk_route.launches)
        metrics = trainer.train_chunk(cache, 4, 3)  # replayed
        torch.cuda.synchronize()
    finally:
        cache.close()
    assert (topk_masked_pair.launches, topk_route.launches) == (before[0] + 3, before[1] + 3)
    assert float(metrics["auxk_loss"][-1]) > 0


# ------------------------------------------- GPU-resident training input


def _activation_store(folder, n_files=12, t=1500, d=384, seed=5):
    """A store of seeded rows, each file tagged with its index at [0, 0]."""
    from freud_tpu_torch.data.store import ActivationStoreWriter

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n_files, t, d)).astype(np.float32)
    data[:, 0, 0] = np.arange(n_files)
    w = ActivationStoreWriter(folder, "encoder.blocks.2", (t, d), (t, d))
    w.append_batch([f"f{i}" for i in range(n_files)], data, n_frames=[t] * n_files)
    w.close()
    return str(folder), data


@pytest.mark.parametrize("variant,batch", [("topk", 4), ("l1", 8)])
def test_train_chunk_graph_matches_eager(cuda, tmp_path, variant, batch):
    """A chunk of 3 steps at tiny width (d_in 384; TopK n_dict 6144 with AuxK
    active, kernel #4 inside the graph) replayed as a CUDA graph is bit-equal
    to the same steps run eagerly from the same state on the same window
    rows, and launches kernel #4 once a replayed step. On these noise rows
    every latent fires, so half of them get a bias that keeps them silent:
    they are dead after the first step, and AuxK runs."""
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache, sample_rows
    from freud_tpu_torch.train.trainer import SAETrainer

    path, _ = _activation_store(tmp_path / "s")
    cfg = ({"expansion_factor": 16, "k": 32, "auxk_alpha": 1 / 32,
            "dead_feature_threshold": batch * 1500 // 2}
           if variant == "topk" else {"n_dict_components": 200, "recon_alpha": 1e4})
    trainer = SAETrainer(variant, cfg, 384, optimizer="adam", scheduler="linear",
                         scheduler_params={"num_warmup_steps": 2}, lr=1e-3, steps=50,
                         device=cuda)
    if variant == "topk":
        with torch.no_grad():
            trainer.params.encoder_bias[::2] = -1e3
    cache = DeviceShuffleCache(path, "encoder.blocks.2", 12, refresh_files=0, device=cuda)
    try:
        trainer.train_step(cache.next_batch(batch))  # unfired latents are dead now
        idx = torch.randint(0, 12, (3, batch), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(1))
        start = [t.clone() for t in trainer._state()]
        before = topk_sae_forward.launches
        graph_m = trainer.train_chunk(cache, batch, 3, indices=idx)
        graph_state = [t.clone() for t in trainer._state()]
        before_replay = topk_sae_forward.launches
        with torch.no_grad():
            for t, s in zip(trainer._state(), start):
                t.copy_(s)
        eager = [trainer._step(sample_rows(cache.cache, idx[i])) for i in range(3)]
    finally:
        cache.close()
    for g, e in zip(graph_state, trainer._state()):
        assert torch.equal(g, e)
    for k, v in graph_m.items():
        assert torch.equal(v, torch.stack([m[k] for m in eager])), k
    if variant == "topk":
        assert float(graph_m["auxk_loss"][0]) > 0
        # the capture's warm-up step launches once; the replay three times
        assert before_replay - before == 1 + 3


def test_refresh_upload_ordered_before_the_sample(cuda, tmp_path):
    """Refreshes upload on the producer's side stream; the copy into the
    window waits on their event, so a sample taken right after (no host
    synchronisation) reads whole store rows, never a row in flight."""
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache

    path, data = _activation_store(tmp_path / "s", n_files=40)
    cache = DeviceShuffleCache(path, "encoder.blocks.2", 8, refresh_files=8, device=cuda)
    want = torch.from_numpy(data).to(cuda)
    first = {int(t) for t in cache.cache[:, 0, 0]}
    try:
        applied, deadline = 0, time.time() + 60
        while applied < 6 and time.time() < deadline:
            applied += cache._q.qsize() > 0
            batch = cache.next_batch(16)  # applies a pending refresh first
            assert torch.equal(batch, want[batch[:, 0, 0].long()])
        assert applied == 6
        assert {int(t) for t in cache.cache[:, 0, 0]} - first
    finally:
        cache.close()


def test_window_that_cannot_fit_raises(cuda, tmp_path):
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache

    path, _ = _activation_store(tmp_path / "s", n_files=4)
    _, total = torch.cuda.mem_get_info(cuda)
    with pytest.raises(ValueError, match="largest device_cache_files that fits is 0"):
        DeviceShuffleCache(path, "encoder.blocks.2", 4, device=cuda, reserve_bytes=total)


# ---------------------------------------------------------------- decoding

DECODE_CLOSE_CALL = 1e-3  # a post-rules top-two margin below this may flip


def _decoder_inputs(cuda):
    from freud_tpu_torch.models.whisper import dims_for, init_decoder, special_tokens

    dims = dims_for("test:tiny")
    dec = init_decoder(dims, seed=4).eval()
    rng = np.random.default_rng(9)
    encoded = torch.from_numpy(rng.standard_normal((2, 1500, 384)).astype(np.float32))
    st = special_tokens(dims.n_vocab)
    prompt = torch.tensor([st.sot_sequence(0)] * 2)
    return dims, dec, encoded, prompt


def test_decoder_on_card_matches_cpu(cuda):
    """Teacher-forced logits and the KV-cached step's rows on the card
    within 1e-4 of max of the CPU's (f32, TF32 off)."""
    from freud_tpu_torch.models.whisper import decoder_forward
    from freud_tpu_torch.models.whisper import decoding as dec_mod

    dims, dec, encoded, prompt = _decoder_inputs(cuda)
    tokens = torch.cat([prompt, torch.randint(0, 50000, (2, 9),
                                              generator=torch.Generator().manual_seed(1))], 1)
    with torch.inference_mode():
        want, _ = decoder_forward(dec, dims, tokens, encoded)
        card = dec.to(cuda)
        got, _ = decoder_forward(card, dims, tokens.to(cuda), encoded.to(cuda))
        assert ((got.cpu() - want).abs().max() / want.abs().max()).item() < 1e-4
        cross = dec_mod._cross_kv_stacks(card, dims, encoded.to(cuda))
        sk, sv = dec_mod._self_kv(dims, 2, tokens.shape[1], torch.float32, cuda)
        pos = torch.zeros((), dtype=torch.int64, device=cuda)
        for p in range(tokens.shape[1]):
            row = dec_mod._decode_step(card, dims, tokens[:, p].to(cuda), pos, sk, sv, cross)
            assert ((row.cpu() - want[:, p]).abs().max() / want.abs().max()).item() < 1e-4
            pos += 1


@pytest.mark.parametrize("beam", [None, 5])
def test_decode_on_card_matches_cpu(cuda, beam):
    """Greedy and beam-5 tokens on the card equal the CPU's up to the first
    step whose CPU post-rules margin is a close call."""
    from freud_tpu_torch.models.whisper import decoding as dec_mod

    dims, dec, encoded, prompt = _decoder_inputs(cuda)
    kw = dict(max_new=24) if beam is None else dict(max_new=24, beam_size=beam)
    fn = dec_mod.sample_decode if beam is None else dec_mod.beam_decode
    want = fn(dec, dims, encoded, prompt, 3, **kw)
    got = fn(dec.to(cuda), dims, encoded.to(cuda), prompt.to(cuda), 3, **kw)
    margins = dec_mod.decision_margins(dec.cpu(), dims, encoded, want[0], 3)
    close = [int(np.argmax(m < DECODE_CLOSE_CALL)) if (m < DECODE_CLOSE_CALL).any()
             else m.shape[0] for m in margins]
    for r in range(2):
        np.testing.assert_array_equal(got[0][r, :close[r]].cpu().numpy(),
                                      want[0][r, :close[r]].numpy())
    assert torch.isfinite(got[1]).all() and got[0].shape == want[0].shape


# ---------------------------------------------------- decoder capture, steering


def test_tapped_step_on_card_matches_oracle(cuda):
    """The KV-cached step with an affine tap at block 0 on the card, against
    the teacher-forced oracle (the tapped block output substituted back) on
    the card, 2e-3 as on the CPU, and against the CPU's tapped step within
    1e-4 of max."""
    from freud_tpu_torch.models.whisper import decoder_forward
    from freud_tpu_torch.models.whisper import decoding as dec_mod

    dims, dec, encoded, prompt = _decoder_inputs(cuda)
    tokens = torch.cat([prompt, torch.randint(0, 50000, (2, 5),
                                              generator=torch.Generator().manual_seed(2))], 1)
    t = tokens.shape[1]

    def affine(tp, x):
        return x * tp[0] + tp[1]

    def steps(module, device):
        tp = (torch.tensor(0.9, device=device), torch.tensor(0.03, device=device))
        enc = encoded.to(device)
        cross = dec_mod._cross_kv_stacks(module, dims, enc)
        sk, sv = dec_mod._self_kv(dims, 2, t, torch.float32, device)
        pos = torch.zeros((), dtype=torch.int64, device=device)
        rows = []
        for p in range(t):
            rows.append(dec_mod._decode_step(module, dims, tokens[:, p].to(device), pos, sk,
                                             sv, cross, tap_layer=0, tap_fn=affine,
                                             tap_params=tp))
            pos += 1
        return torch.stack(rows, 1), tp

    with torch.inference_mode():
        want, _ = steps(dec, torch.device("cpu"))
        card = dec.to(cuda)
        got, tp = steps(card, cuda)
        name = "decoder.blocks.0"
        args = (card, dims, tokens.to(cuda), encoded.to(cuda))
        _, caps = decoder_forward(*args, capture=(name,))
        oracle, _ = decoder_forward(*args, substitute={name: affine(tp, caps[name])})
    torch.testing.assert_close(got, oracle, atol=2e-3, rtol=2e-3)
    assert ((got.cpu() - want).abs().max() / want.abs().max()).item() < 1e-4


def test_decode_capture_on_card_matches_cpu(cuda, monkeypatch):
    """``activations_with_decode`` at test:tiny (decoder block 1) on the
    card against the CPU: tokens and valid positions equal up to the first
    CPU close call, activations within 1e-4 of max there (f32, TF32 off;
    the encoder's attention takes the plain f32 path on the card too, as
    kernel #2's bf16 products alone move the encoding by more than that)."""
    from freud_tpu_torch.models.whisper import decoding as dec_mod
    from freud_tpu_torch.models.whisper import model as model_mod

    monkeypatch.setattr(model_mod, "ATTENTION_IMPL", "einsum")
    mels = torch.from_numpy(
        (np.random.default_rng(3).standard_normal((2, 80, 3000)) * 0.4).astype(np.float32))
    rts = {d: WhisperRuntime("test:tiny", "decoder.blocks.1", max_new_tokens=12, device=d)
           for d in ("cpu", "cuda")}
    want = rts["cpu"].activations_with_decode(mels)
    got = rts["cuda"].activations_with_decode(mels.to(cuda))
    assert got[0].is_cuda and tuple(got[0].shape) == (2, 15, 384)
    cpu_rt = rts["cpu"]
    encoded = cpu_rt.encode(mels)
    margins = dec_mod.decision_margins(cpu_rt.decoder, cpu_rt.dims, encoded, want[2], 3)
    for r in range(2):
        close = margins[r] < DECODE_CLOSE_CALL
        upto = int(np.argmax(close)) if close.any() else 15
        assert torch.equal(got[2][r, :upto].cpu(), want[2][r, :upto])
        err = (got[0][r, :upto].cpu() - want[0][r, :upto]).abs().max()
        assert (err / want[0].abs().max()).item() < 1e-4
        if upto == 15:
            assert int(got[1][r]) == int(want[1][r])


# ------------------------------------------------- the SAE encode's top-k

INDEXED_WIDTHS = [20480, 57344, 1001]  # one segment (f32), two (f32), rows not in 16 bytes


NAN_ROW = 7


def _indexed_rows(rng, m, n, k, dtype, device):
    """ReLU rows with the cases the sort's order makes subtle, each in a
    few rows: fewer than k positives, all zeros, -0.0 among +0.0, +inf,
    NaN of either sign and of several payloads (row ``NAN_ROW``), many
    exact ties at the k-th value."""
    x = np.maximum(rng.standard_normal((m, n)), 0).astype(np.float32)
    sparse = rng.random((m, n)) < min(0.5, k / n)  # rows 0-3: fewer than k positives
    x[:4] = np.where(sparse[:4], x[:4], 0.0)
    x[4] = 0.0
    x[5] = 0.0
    x[5, ::3] = -0.0
    x[5, 7] = 1.0
    x[6, rng.choice(n, 3, replace=False)] = np.inf
    nan = rng.choice(n, 8, replace=False)
    x[NAN_ROW].view(np.uint32)[nan] = [0x7FC00000, 0x7FC00000, 0x7FA00000, 0x7FC10000,
                                       0xFFC00000, 0xFFC00000, 0xFFA00000, 0xFF810000]
    x[NAN_ROW, rng.choice(n, 2, replace=False)] = np.inf
    x[8, :] = 0.5  # every entry tied
    x[9, ::2] = 0.75  # half the row tied above the rest
    x[10] = -x[10]  # no positive entry, no zero
    x[11, : n // 2] = -0.0
    t = torch.from_numpy(x).to(device=device, dtype=dtype)
    return t


def _assert_indexed_equal(got, want):
    iv = torch.int32 if got[0].dtype == torch.float32 else torch.int16
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].contiguous().view(iv), want[0].contiguous().view(iv))


@pytest.mark.parametrize("k", [1, 16, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", INDEXED_WIDTHS)
def test_topk_indexed_bit_equal_to_the_stable_sort(cuda, n, dtype, k):
    from freud_tpu_torch.ops.topk_indexed import topk_indexed, topk_indexed_plain

    rng = np.random.default_rng(n + k)
    x = _indexed_rows(rng, 300, n, k, dtype, cuda)
    before = topk_indexed.launches
    got = topk_indexed(x, k)
    torch.cuda.synchronize()
    assert topk_indexed.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.int64
    _assert_indexed_equal(got, topk_indexed_plain(x, k))
    # the CPU's sort too, but on NaN (it puts every NaN on top)
    rows = [i for i in range(x.shape[0]) if i != NAN_ROW]
    want = topk_indexed_plain(x[rows].cpu(), k)
    _assert_indexed_equal((got[0][rows].cpu(), got[1][rows].cpu()), want)
    _assert_indexed_equal(topk_indexed(x[:, None], k), (got[0][:, None], got[1][:, None]))


@pytest.mark.parametrize("n", INDEXED_WIDTHS)
def test_topk_indexed_fused_bias_relu_bit_equal(cuda, n):
    """relu(z + b_enc) formed in the kernel's load against the separate add
    and ReLU then the sort, with -0.0 and NaN in the product and the bias."""
    from freud_tpu_torch.ops.topk_indexed import topk_indexed, topk_indexed_plain

    rng = np.random.default_rng(n)
    z = torch.from_numpy(rng.standard_normal((400, n)).astype(np.float32)).to(cuda)
    b = torch.from_numpy((rng.standard_normal(n) * 0.5).astype(np.float32)).to(cuda)
    z[0] = -0.0
    b[: n // 4] = -0.0
    z[1, 5] = float("nan")
    z[2, 9] = -float("nan")
    z[3] = -b  # exact zeros after the add
    z[4] = -10.0  # nothing positive
    got = topk_indexed(z, 32, bias=b)
    want = topk_indexed_plain(torch.relu(z + b), 32)
    _assert_indexed_equal(got, want)
    _assert_indexed_equal(got, topk_indexed_plain(z, 32, bias=b))


def test_topk_indexed_under_graph_capture(cuda):
    from freud_tpu_torch.ops.topk_indexed import topk_indexed, topk_indexed_plain

    rng = np.random.default_rng(3)
    x = _indexed_rows(rng, 500, 57344, 32, torch.float32, cuda)
    topk_indexed(x, 32)  # builds and loads before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    before = (topk_indexed.launches, topk_indexed.captured)
    with torch.cuda.graph(g):
        out = topk_indexed(x, 32)
    assert (topk_indexed.launches, topk_indexed.captured) == (before[0], before[1] + 1)
    x.copy_(_indexed_rows(rng, 500, 57344, 32, torch.float32, cuda))
    g.replay()
    torch.cuda.synchronize()
    _assert_indexed_equal(out, topk_indexed_plain(x, 32))


@pytest.mark.parametrize("m,n", [(48000, 20480), (6400, 57344)])
def test_topk_indexed_main_path_shapes(cuda, m, n):
    """collection's and the omni SAE's (M, n_dict) f32 latents: no launch
    refused, bit-equal to the sort; the wrapper's segment widths are the
    library's."""
    from freud_tpu_torch.ops import topk_indexed as ti
    from freud_tpu_torch.ops.topk_indexed import topk_indexed, topk_indexed_plain

    assert [_native.limit("topk_indexed", "freud_topk_indexed_max_n", bf16)
            for bf16 in (0, 1)] == [ti.MAX_N[torch.float32], ti.MAX_N[torch.bfloat16]]

    gen = torch.Generator(device=cuda).manual_seed(m)
    x = torch.relu(torch.randn((m, n), device=cuda, generator=gen) - 1.0)
    x[m - 7:] = 0.0  # zero-padded tail rows
    b = torch.randn(n, device=cuda, generator=gen) * 0.1
    got = topk_indexed(x, 32, bias=b)
    torch.cuda.synchronize()
    _assert_indexed_equal(got, topk_indexed_plain(x, 32, bias=b))


def test_encode_on_card_takes_the_kernel_and_matches_cpu(cuda, monkeypatch):
    """``encode`` and ``select_topk`` on the card: one launch each, no
    ``torch.sort``, bit-equal to the sort of the card's own ``pre_acts``,
    and the CPU's encode on the same inputs within the f32 products'
    rounding."""
    from freud_tpu_torch.models.sae import topk as topk_mod
    from freud_tpu_torch.models.sae.config import TopKAutoEncoderConfig
    from freud_tpu_torch.ops.topk_indexed import topk_indexed, topk_indexed_plain

    cfg = TopKAutoEncoderConfig(k=32, expansion_factor=16)
    params = topk_mod.init_topk(1280, cfg, seed=5)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        params.encoder_bias.copy_(torch.randn(20480, generator=gen) * 0.05)
        x = torch.randn((2, 750, 1280), generator=gen)
        x[1, 700:] = params.b_dec  # silent frames: every latent at its bias
    card = copy.deepcopy(params).to(cuda)
    xc = x.to(cuda)
    with torch.no_grad():
        want = topk_indexed_plain(topk_mod.pre_acts(card, xc), 32)

        def no_sort(*a, **kw):
            raise AssertionError("torch.sort over a row on the card")

        monkeypatch.setattr(torch, "sort", no_sort)
        before = topk_indexed.launches
        got = topk_mod.encode(card, xc, cfg)
        sel = topk_mod.select_topk(topk_mod.pre_acts(card, xc), 32)
        torch.cuda.synchronize()
        assert topk_indexed.launches == before + 2
        monkeypatch.undo()
        _assert_indexed_equal(got, want)
        _assert_indexed_equal(sel, want)
        cpu = topk_mod.encode(params, x, cfg)
        dense = topk_mod.pre_acts(params, x)
    scale = cpu.top_acts.abs().max().item()
    assert (got.top_acts.cpu() - cpu.top_acts).abs().max().item() < 1e-5 * scale
    # where the indices differ, the card's choice is as large on the CPU
    picked = torch.gather(dense, -1, got.top_indices.cpu())
    assert (picked - cpu.top_acts).abs().max().item() < 1e-5 * scale
    assert (got.top_indices.cpu() != cpu.top_indices).float().mean().item() < 1e-3


# ------------------------------------------------------- the 3xTF32 product

GEMM_GATE_SHAPES = [(1280, 1280), (1280, 5120), (5120, 1280), (1280, 20480), (3584, 57344)]


def _gemm_operands(cuda, m, k, n, seed, bias=True):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((m, k), device=cuda, generator=gen)
    w = (torch.rand((n, k), device=cuda, generator=gen) * 2 - 1) / k ** 0.5
    b = torch.randn(n, device=cuda, generator=gen) * 0.1 if bias else None
    return x, w, b


def _rms_err(y, ref):
    return ((y.double() - ref).abs().max() / ref.pow(2).mean().sqrt()).item()


@pytest.mark.parametrize("m", [1500, 4096])
@pytest.mark.parametrize("k,n", GEMM_GATE_SHAPES)
def test_gemm_f32x3_accuracy_gate(cuda, m, k, n):
    """At the cells' shapes the kernel's largest error against a float64
    product, over the output's RMS, is at most 2× cuBLAS f32's on the same
    operands (TF32 off) and at least 30× under one TF32 product's."""
    from freud_tpu_torch.ops.gemm_f32x3 import gemm_f32x3

    x, w, b = _gemm_operands(cuda, m, k, n, seed=k + n + m, bias=n <= 5120)
    with torch.no_grad():
        ref = x.double() @ w.double().T
        if b is not None:
            ref += b.double()
        got = _rms_err(gemm_f32x3(x, w, b), ref)
        f32 = _rms_err(torch.nn.functional.linear(x, w, b), ref)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = _rms_err(torch.nn.functional.linear(x, w, b), ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    assert got <= 2 * f32, (got, f32)
    assert 30 * got <= tf32, (got, tf32)


@pytest.mark.parametrize("m,k,n,bias", [(1500, 1280, 1280, True), (1, 32, 8, True),
                                        (130, 36, 130, False), (77, 64, 5, True),
                                        (257, 384, 1536, True)])
def test_gemm_f32x3_repeats_and_follows_the_recipe(cuda, m, k, n, bias):
    """Two launches agree bit for bit; ragged M, N and K (past the tile,
    the slice, an odd N) within the recipe's bound of the plain version;
    one launch a call."""
    from freud_tpu_torch.ops.gemm_f32x3 import gemm_f32x3, gemm_f32x3_plain

    x, w, b = _gemm_operands(cuda, m, k, n, seed=m + k, bias=bias)
    with torch.no_grad():
        before = gemm_f32x3.launches
        y1 = gemm_f32x3(x.view(1, m, k), w, b)
        y2 = gemm_f32x3(x, w, b)
        torch.cuda.synchronize()
        assert gemm_f32x3.launches == before + 2
        assert y1.shape == (1, m, n) and torch.equal(y1[0], y2)
        ref = x.double() @ w.double().T + (b.double() if bias else 0)
        plain = gemm_f32x3_plain(x, w, b)
    assert _rms_err(y2, ref) <= 2 * _rms_err(plain, ref) + 2.0 ** -23


def test_gemm_f32x3_weight_limbs_follow_an_in_place_change(cuda):
    """W changed in place, with its version counter moved or not (through
    ``.data``), is read as it is now."""
    from freud_tpu_torch.ops.gemm_f32x3 import gemm_f32x3

    x, w, b = _gemm_operands(cuda, 512, 256, 384, seed=9)
    w = torch.nn.Parameter(w, requires_grad=False)
    with torch.no_grad():
        first = gemm_f32x3(x, w, b)
        w.mul_(-2.0)
        second = gemm_f32x3(x, w, b)
        fresh = gemm_f32x3(x, w.detach().clone(), b)
        version = w._version
        w.data.mul_(0.5)
        assert w._version == version
        third = gemm_f32x3(x, w, b)
        fresh3 = gemm_f32x3(x, w.detach().clone(), b)
    assert torch.equal(second, fresh) and not torch.equal(first, second)
    assert torch.equal(third, fresh3) and not torch.equal(second, third)


def test_gemm_f32x3_under_graph_capture(cuda):
    from freud_tpu_torch.ops.gemm_f32x3 import gemm_f32x3

    x, w, b = _gemm_operands(cuda, 1500, 1280, 5120, seed=11)
    with torch.no_grad():
        gemm_f32x3(x, w, b)  # builds and loads the library before the capture
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        before = (gemm_f32x3.launches, gemm_f32x3.captured)
        with torch.cuda.graph(g):
            out = gemm_f32x3(x, w, b)
        assert (gemm_f32x3.launches, gemm_f32x3.captured) == (before[0], before[1] + 1)
        x2, w2, _ = _gemm_operands(cuda, 1500, 1280, 5120, seed=12)
        x.copy_(x2)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gemm_f32x3(x, w, b))
        w.copy_(w2)  # the replay splits W again: it reads the new weight
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gemm_f32x3(x, w, b))


def test_gemm_f32x3_launches_per_encoder_forward_and_encode(cuda):
    """One launch per routed linear (q, k, v, out, mlp.0, mlp.2 of each
    block at d 1280) and one per SAE encode; none in bf16, under autograd,
    or for a decode step's few rows."""
    from freud_tpu_torch.models.sae import topk as topk_mod
    from freud_tpu_torch.models.sae.config import TopKAutoEncoderConfig
    from freud_tpu_torch.models.whisper import init_encoder
    from freud_tpu_torch.ops.gemm_f32x3 import gemm_f32x3, linear

    dims = WhisperDims(n_mels=80, n_audio_ctx=1500, n_audio_state=1280,
                       n_audio_head=20, n_audio_layer=2, n_vocab=51865,
                       n_text_ctx=448, n_text_state=1280, n_text_head=20,
                       n_text_layer=1)
    enc = init_encoder(dims, seed=4)
    mels = torch.from_numpy(
        np.random.default_rng(14).standard_normal((1, 80, 3000)).astype(np.float32) * 0.5)
    cfg = TopKAutoEncoderConfig(k=32, expansion_factor=16)
    params = topk_mod.init_topk(1280, cfg, seed=5).to(cuda)
    with torch.inference_mode():
        want = enc(mels, capture=("encoder.blocks.1",))[1]["encoder.blocks.1"]
        enc = enc.to(cuda)
        before = gemm_f32x3.launches
        got = enc(mels.to(cuda), capture=("encoder.blocks.1",))[1]["encoder.blocks.1"]
        topk_mod.encode(params, got, cfg)
        torch.cuda.synchronize()
        assert gemm_f32x3.launches == before + 6 * 2 + 1
        before = gemm_f32x3.launches
        linear(got[:, :100], enc.blocks[0].mlp[0].weight)  # under a row tile
        enc.to(torch.bfloat16)(mels.to(cuda, torch.bfloat16), capture=("encoder.blocks.0",))
        torch.cuda.synchronize()
        assert gemm_f32x3.launches == before
    x = got.clone().requires_grad_(True)
    with torch.enable_grad():
        topk_mod.pre_acts(params, x).sum().backward()
    assert gemm_f32x3.launches == before
    got = got.cpu()
    assert ((got - want).abs().max() / want.abs().max()).item() < 5e-2


def test_validation_between_graph_replays_reads_the_current_encoder(cuda, tmp_path,
                                                                   monkeypatch):
    """The train chunks update the encoder weight in place inside CUDA graph
    replays, which move no version counter. Validation after each chunk
    runs its SAE encode on the 3xTF32 product and reads the weight as the
    replays left it: its statistics and reconstructions match a validation
    of the same state on ``F.linear``."""
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache
    from freud_tpu_torch.ops import gemm_f32x3 as G
    from freud_tpu_torch.train.trainer import SAETrainer

    path, data = _activation_store(tmp_path / "s")
    trainer = SAETrainer("topk", {"expansion_factor": 16, "k": 32}, 384, optimizer="adam",
                         lr=1e-2, steps=50, device=cuda)
    val = data[:2]
    cache = DeviceShuffleCache(path, "encoder.blocks.2", 12, refresh_files=0, device=cuda)
    seen = []
    try:
        for _ in range(3):
            trainer.train_chunk(cache, 4, 3)  # captured once, then replayed
            before = G.gemm_f32x3.launches
            got = trainer.validate_files(val, sae_out=True)
            assert G.gemm_f32x3.launches == before + len(val)
            with monkeypatch.context() as mp:
                mp.setattr(G, "takes_kernel", lambda *a: False)
                want = trainer.validate_files(val, sae_out=True)
            seen.append(got["fvu"])
            np.testing.assert_allclose(got["fvu"], want["fvu"], rtol=1e-4)
            np.testing.assert_allclose(got["sae_out"], want["sae_out"], rtol=0,
                                       atol=1e-4 * np.abs(want["sae_out"]).max())
    finally:
        cache.close()
    assert not np.array_equal(seen[0], seen[-1])  # the replays moved the encoder
