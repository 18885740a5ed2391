"""The 3xTF32 product (``ops/gemm_f32x3``) on the CPU: its recipe in plain
PyTorch (TF32 rounding by bit masking, the three limb products, the slices'
promoted sums) against a float64 product and the f32 product, the routing
rule of ``linear`` (which shapes, dtypes and grad states take the kernel),
the call sites that route through it, and that nothing of a weight is
kept between calls. The kernel itself is held against float64, cuBLAS f32 and one-pass TF32 on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from freud_tpu_torch.models.sae import topk as ttopk
from freud_tpu_torch.models.sae.config import TopKAutoEncoderConfig
from freud_tpu_torch.models.whisper import WhisperDims, init_encoder
from freud_tpu_torch.ops import gemm_f32x3 as G


def _tf32_numpy(v: np.ndarray) -> np.ndarray:
    """TF32 rounding, ties away from zero, done on the value: 10 mantissa
    bits kept of |v| rounded half up."""
    out = np.empty_like(v)
    for i, x in enumerate(v.astype(np.float64)):
        if x == 0 or not np.isfinite(x):
            out[i] = x
            continue
        e = np.floor(np.log2(abs(x)))
        ulp = 2.0 ** (e - 10)
        out[i] = np.sign(x) * np.floor(abs(x) / ulp + 0.5) * ulp
    return out


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (n, k)) / np.sqrt(k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    return x, w, b


def _err(y, ref):
    """Largest error over the reference's RMS."""
    return ((y.double() - ref).abs().max() / ref.pow(2).mean().sqrt()).item()


def test_tf32_round_is_rna():
    rng = np.random.default_rng(1)
    v = np.concatenate([
        rng.standard_normal(2000) * 10.0 ** rng.integers(-20, 20, 2000),
        [0.0, -0.0, 1.0, -1.0, 2.0 ** -130, 3.0e38, np.inf, -np.inf]]).astype(np.float32)
    got = G.tf32_round(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, _tf32_numpy(v).astype(np.float32))
    assert (got.view(np.int32) & 0x1FFF == 0).all()
    # an exact tie rounds away from zero: 1 + 2⁻¹¹ → 1 + 2⁻¹⁰
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], dtype=np.float32)
    np.testing.assert_array_equal(G.tf32_round(torch.from_numpy(tie)).numpy(),
                                  [1 + 2.0 ** -10, -(1 + 2.0 ** -10)])


def test_split_limbs_keep_f32_precision():
    v = _operands(64, 256, 1)[0]
    hi, lo = G.split_limbs(v)
    assert torch.equal(G.tf32_round(hi), hi) and torch.equal(G.tf32_round(lo), lo)
    assert torch.equal(G.tf32_round(v - hi), lo)
    # hi + lo within 2⁻²² of v (lo's own rounding); hi alone only 2⁻¹¹
    rel = ((hi.double() + lo.double() - v.double()).abs() / v.double().abs()).max().item()
    assert rel <= 2.0 ** -22
    assert ((hi.double() - v.double()).abs() / v.double().abs()).max().item() <= 2.0 ** -11
    # a strided view splits into the limbs of its values, laid out row-major
    hi_t, lo_t = G.split_limbs(v.T)
    assert hi_t.is_contiguous() and lo_t.is_contiguous()
    assert torch.equal(hi_t, hi.T) and torch.equal(lo_t, lo.T)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(128, 32, 64), (130, 36, 130), (257, 384, 96),
                                   (300, 1280, 64), (33, 5120, 40)])
def test_plain_recipe_against_float64_and_f32(m, k, n, bias):
    """Within 2× the f32 product's error against float64 (plus f32's own
    unit), and at least 30× under one TF32 product's, at shapes whose M
    and K are not multiples of the tile and slice."""
    x, w, b = _operands(m, k, n, seed=m + k)
    b = b if bias else None
    ref = x.double() @ w.double().T + (b.double() if bias else 0)
    got = G.gemm_f32x3_plain(x, w, b)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    f32 = _err(F.linear(x, w, b), ref)
    tf32 = _err(F.linear(G.tf32_round(x), G.tf32_round(w), b), ref)
    err = _err(got, ref)
    assert err <= 2 * f32 + 2.0 ** -23
    assert 30 * err <= tf32


def test_plain_recipe_keeps_leading_axes():
    x, w, b = _operands(2 * 150, 64, 48, seed=3)
    got = G.gemm_f32x3_plain(x.view(2, 150, 64), w, b)
    assert got.shape == (2, 150, 48)
    assert torch.equal(got.reshape(300, 48), G.gemm_f32x3_plain(x, w, b))


class _Fake:
    """What ``takes_kernel`` reads of a tensor, on a device this host lacks."""

    def __init__(self, *shape, cuda=True, dtype=torch.float32, requires_grad=False):
        self.shape, self.is_cuda, self.dtype = shape, cuda, dtype
        self.requires_grad, self.ndim = requires_grad, len(shape)

    def numel(self):
        return int(np.prod(self.shape))


ROUTES = [
    # (x, w, bias, grad enabled, takes the kernel)
    (_Fake(32, 1500, 1280), _Fake(1280, 1280), _Fake(1280), False, True),  # collection
    (_Fake(1, 1500, 1280), _Fake(5120, 1280), _Fake(5120), True, True),    # no grad kept
    (_Fake(6400, 3584), _Fake(57344, 3584), None, False, True),            # omni SAE encode
    (_Fake(128, 384), _Fake(1536, 384), _Fake(1536), False, True),         # one row tile
    (_Fake(127, 384), _Fake(1536, 384), _Fake(1536), False, False),        # under a tile
    (_Fake(5, 1, 1280), _Fake(1280, 1280), _Fake(1280), False, False),     # a decode step
    (_Fake(512, 1282), _Fake(64, 1282), None, False, False),               # K % 4
    (_Fake(512, 1280, dtype=torch.bfloat16), _Fake(1280, 1280, dtype=torch.bfloat16),
     None, False, False),                                                  # bf16
    (_Fake(512, 1280), _Fake(1280, 1280, dtype=torch.bfloat16), None, False, False),
    (_Fake(512, 1280, cuda=False), _Fake(1280, 1280, cuda=False), None, False, False),
    (_Fake(512, 1280), _Fake(1280, 1280, cuda=False), None, False, False),  # mixed devices
    (_Fake(512, 1280), _Fake(1280, 1280, requires_grad=True), _Fake(1280), True, False),
    (_Fake(512, 1280, requires_grad=True), _Fake(1280, 1280), None, True, False),
    (_Fake(512, 1280), _Fake(1280, 1280), _Fake(1280, requires_grad=True), True, False),
    (_Fake(512, 1280), _Fake(1280, 1280, requires_grad=True), _Fake(1280), False, True),
    (_Fake(512, 1280), _Fake(1280, 1280), _Fake(1280, dtype=torch.bfloat16), False, False),
]


@pytest.mark.parametrize("case", range(len(ROUTES)))
def test_routing_rule(case):
    x, w, b, grad, want = ROUTES[case]
    with torch.set_grad_enabled(grad):
        assert G.takes_kernel(x, w, b) is want


def test_cpu_linear_is_f_linear_and_launches_nothing():
    x, w, b = _operands(300, 64, 32, seed=4)
    before = (G.gemm_f32x3.launches, G.gemm_f32x3.captured)
    with torch.no_grad():
        assert torch.equal(G.linear(x, w, b), F.linear(x, w, b))
        assert torch.equal(G.linear(x, w), F.linear(x, w))
    assert (G.gemm_f32x3.launches, G.gemm_f32x3.captured) == before


def test_wrapper_checks_and_cpu_plain():
    x, w, b = _operands(130, 36, 20, seed=5)
    assert torch.equal(G.gemm_f32x3(x, w, b), G.gemm_f32x3_plain(x, w, b))
    with pytest.raises(TypeError):
        G.gemm_f32x3(x.double(), w, b)
    with pytest.raises(ValueError):
        G.gemm_f32x3(x, w[:, :32], b)
    with pytest.raises(ValueError):
        G.gemm_f32x3(x, w, b[:10])


@pytest.fixture
def route_cpu(monkeypatch):
    """``linear`` and the SAE encode routed as a card would route them, on
    the CPU: every call that would launch runs the plain recipe, counted."""
    calls = []

    def recipe(x, w, bias=None):
        calls.append((tuple(x.shape), tuple(w.shape), bias is not None))
        return G.gemm_f32x3_plain(x, w, bias)

    def rule(x, w, bias=None):
        return (not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad))
                and x.dtype == w.dtype == torch.float32
                and x.numel() // x.shape[-1] >= G.ROW_TILE)

    monkeypatch.setattr(G, "takes_kernel", rule)
    monkeypatch.setattr(G, "gemm_f32x3", recipe)
    return calls


def test_encoder_forward_routes_six_linears_a_block(route_cpu):
    """q, k, v, out, mlp.0 and mlp.2 of every encoder block, and the SAE
    encode's product: one call each, within f32 rounding of the plain
    forward."""
    dims = WhisperDims(n_mels=80, n_audio_ctx=200, n_audio_state=64, n_audio_head=4,
                       n_audio_layer=3, n_vocab=51865, n_text_ctx=448, n_text_state=64,
                       n_text_head=4, n_text_layer=1)
    enc = init_encoder(dims, seed=2)
    mels = torch.from_numpy(
        np.random.default_rng(3).standard_normal((2, 80, 400)).astype(np.float32))
    with torch.inference_mode():
        got = enc(mels, capture=("encoder.blocks.2",))[1]["encoder.blocks.2"].clone()
    assert len(route_cpu) == 6 * 3
    assert {c[1] for c in route_cpu} == {(64, 64), (256, 64), (64, 256)}
    assert [c[2] for c in route_cpu[:6]] == [True, False, True, True, True, True]
    route_cpu.clear()
    with torch.enable_grad():  # parameters that record a graph: F.linear
        plain = enc(mels, capture=("encoder.blocks.2",))[1]["encoder.blocks.2"].detach()
    assert route_cpu == []
    scale = plain.abs().max().item()
    assert (got - plain).abs().max().item() < 1e-5 * scale
    got = got.clone()  # a normal tensor, outside inference mode

    cfg = TopKAutoEncoderConfig(k=8, expansion_factor=4)
    params = ttopk.init_topk(64, cfg, seed=1)
    route_cpu.clear()
    with torch.no_grad():
        z = ttopk._encoder_product(params, got)
    assert route_cpu == [((2, 200, 64), (256, 64), False)]
    want_z = (got - params.b_dec) @ params.encoder_weight.detach().T
    assert (z - want_z).abs().max().item() < 1e-5 * want_z.abs().max().item()
    route_cpu.clear()
    with torch.enable_grad():  # the trainer's autograd products stay plain
        ttopk._encoder_product(params, got)
        ttopk._encoder_product(params, got, matmul_dtype=torch.bfloat16)
    assert route_cpu == []


@pytest.mark.parametrize("change", ["in_place", "through_data", "new_storage", "inference"])
def test_product_reads_the_weight_as_it_is_now(change):
    """Nothing of W is kept between calls: after W changes in place (its
    version counter moves), through ``.data`` (no counter moves, as in a
    CUDA graph's replay), by new storage, or as an inference tensor (no
    counter at all), the product reads the new W."""
    x, w0, b = _operands(200, 64, 48, seed=6)
    new = torch.randn(48, 64) / 8
    with torch.inference_mode(change == "inference"):
        w = w0.clone() if change == "inference" else torch.nn.Parameter(w0.clone())
        with torch.no_grad():
            first = G.gemm_f32x3(x, w, b)
            if change == "in_place":
                w.copy_(new)
            elif change == "through_data":
                version = w._version
                w.data.copy_(new)
                assert w._version == version
            elif change == "new_storage":
                w.data = new.clone()
            else:
                w.copy_(new)
            got = G.gemm_f32x3(x, w, b)
    assert not torch.equal(first, got)
    assert torch.equal(got, G.gemm_f32x3_plain(x, new, b))
