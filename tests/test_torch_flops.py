"""freud_tpu_torch.flops against freud_tpu.flops (the same conventions), the
card's peak table, and each kernel's operations, bytes and bound at its
main-path shape — the numbers of PERF.md's kernel table."""

import ast
from pathlib import Path

import pytest

from freud_tpu import flops as jflops
from freud_tpu.models.whisper import dims_for as jdims_for
from freud_tpu_torch import flops
from freud_tpu_torch.models.whisper import dims_for

SIZES = ["tiny", "large-v1", "large-v3"]


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_flops_equal(n_mels):
    assert flops.mel_flops(n_mels) == jflops.mel_flops(n_mels)
    assert flops.mel_flops(n_mels, 1500) == jflops.mel_flops(n_mels, 1500)


@pytest.mark.parametrize("name", SIZES)
def test_encoder_flops_equal(name):
    for include_mel in (True, False):
        assert flops.encoder_flops(dims_for(name), include_mel) == \
            jflops.encoder_flops(jdims_for(name), include_mel)


@pytest.mark.parametrize("rows,d_in,n_dict", [(75000, 384, 6144), (48000, 1280, 20480)])
def test_sae_step_flops_equal(rows, d_in, n_dict):
    assert flops.sae_l1_step_flops(rows, d_in, n_dict) == \
        jflops.sae_l1_step_flops(rows, d_in, n_dict)
    for live in (True, False):
        assert flops.sae_topk_step_flops(rows, d_in, n_dict, live) == \
            jflops.sae_topk_step_flops(rows, d_in, n_dict, live)


@pytest.mark.parametrize("name", SIZES)
def test_decode_flops_equal(name):
    for mean_pos in (None, 40.0):
        assert flops.decode_flops(dims_for(name), 8, 60, mean_pos) == \
            jflops.decode_flops(jdims_for(name), 8, 60, mean_pos)


def test_peaks_keyed_by_card_name():
    h100 = flops.peaks_for_name("NVIDIA H100 80GB HBM3")
    assert h100 == {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "bytes": 3.35e12}
    assert flops.peaks_for_name("NVIDIA A100-SXM4-80GB") is None
    assert flops.peaks_for_name("") is None


def test_mfu_pct_against_the_cards_bf16_peak(monkeypatch):
    """JAX's formula (percent of the bf16 peak); None without a card the
    table holds, as JAX's is off a TPU, and for a non-positive time."""
    assert flops.mfu_pct(1e12, 1.0) is None
    assert jflops.mfu_pct(1e12, 1.0) is None
    monkeypatch.setattr(flops, "device_peaks", lambda: flops.H100)
    monkeypatch.setattr(jflops, "device_peak_flops", lambda: flops.H100["bf16"])
    for total, secs in ((1e12, 1.0), (3.3e15, 7.25)):
        assert flops.mfu_pct(total, secs) == jflops.mfu_pct(total, secs)
    assert flops.mfu_pct(989e12, 2.0) == pytest.approx(50.0)
    assert flops.mfu_pct(1e12, 0.0) is None


# (bound, ops, bytes, bound ms rounded to 4 places, bound_by) at the main
# paths' shapes, as PERF.md's kernel table states them
MAIN_PATH = [
    (flops.log_mel_bound(32, 80), 92.695872e9, 92.16e6, 0.0948, "operations"),
    (flops.fused_qkv_attention_bound(32, 1500, 384, 6), 153.059328e9, 149.228544e6,
     0.1548, "operations"),
    (flops.topk_thresholds_bound(75000, 6144), 0.0, 922.512288e6, 0.2754, "bytes"),
    (flops.topk_thresholds_bound(75000, 6144, in_bytes=4), 0.0, 1844.112288e6, 0.5505,
     "bytes"),
    (flops.topk_select_bound(48000, 20480), 0.0, 1966.46912e6, 0.587, "bytes"),
    (flops.topk_select_bound(75000, 6144), 0.0, 922.201536e6, 0.2753, "bytes"),
    (flops.topk_sae_forward_bound(48000, 1280, 20480, 32, 640), 2.59915776e12,
     2.9135872e9, 2.6281, "operations"),
    (flops.topk_sae_forward_bound(75000, 384, 6144, 32, 192), 366.7968e9,
     1.286712768e9, 0.3841, "bytes"),
    (flops.whisper_attention_bound(32, 20, 1500), 368.64e9, 983.04e6, 0.3727, "operations"),
    (flops.whisper_attention_bound(16, 20, 1500), 184.32e9, 491.52e6, 0.1864, "operations"),
    (flops.whisper_attention_bound(16, 20, 1500, in_bytes=2), 184.32e9, 245.76e6, 0.1864,
     "operations"),
    # Whisper small's multi-layer collection and the sweeps' TopK step
    (flops.fused_qkv_attention_bound(16, 1500, 768, 12), 195.526656e9, 154.540032e6,
     0.1977, "operations"),
    (flops.topk_sae_forward_bound(12000, 768, 12288, 32, 384), 234.160128e9,
     481.174272e6, 0.2368, "operations"),
    # kernel #4's encode and decode launches on large_v1_audioset's shard
    # of a dictionary split in two (the decode at 336 selected entries a row)
    (flops.topk_sae_encode_bound(48000, 1280, 10240), 1.2582912e12, 1.28127488e9,
     1.2723, "operations"),
    (flops.topk_sae_decode_bound(48000, 1280, 10240, 48000 * 336), 41.28768e9,
     1.52738304e9, 0.4559, "bytes"),
    # the 3xTF32 product at large collection's q/k/v/out and the omni SAE encode
    (flops.gemm_f32x3_bound(48000, 1280, 1280), 471.8592e9, 524.29312e6, 0.9533,
     "operations"),
    (flops.gemm_f32x3_bound(6400, 3584, 57344, bias=False), 7.8920024064e12,
     5.67017472e9, 15.9434, "operations"),
    # the TopK backward's masked pair and route: 6 and 8 bytes an entry in
    # bf16, 12 and 16 on the f32 route
    (flops.topk_bwd_pair_bound(48000, 20480), 0.0, 5.89870592e9, 1.7608, "bytes"),
    (flops.topk_bwd_route_bound(48000, 20480), 0.0, 7.86486784e9, 2.3477, "bytes"),
    (flops.topk_bwd_pair_bound(75000, 6144), 0.0, 2.765424576e9, 0.8255, "bytes"),
    (flops.topk_bwd_route_bound(75000, 6144), 0.0, 3.687049152e9, 1.1006, "bytes"),
    (flops.topk_bwd_pair_bound(75000, 6144, in_bytes=4), 0.0, 5.530224576e9, 1.6508,
     "bytes"),
    (flops.topk_bwd_route_bound(75000, 6144, in_bytes=4), 0.0, 7.373449152e9, 2.201,
     "bytes"),
    # the SAE encode's indexed top-k, f32 with the fused bias, k 32: the
    # collection batch, the omni SAE's batch, one serving request
    (flops.topk_indexed_bound(48000, 20480, 32, bias=True), 0.0, 3.95067392e9, 1.1793,
     "bytes"),
    (flops.topk_indexed_bound(6400, 57344, 32, bias=True), 0.0, 1.470693376e9, 0.439,
     "bytes"),
    (flops.topk_indexed_bound(1500, 20480, 32, in_bytes=2), 0.0, 61.92e6, 0.0185, "bytes"),
    # Uni-MoE-2.0-Omni's MoE at the omni cell's batch: 7,424 tokens, 10,558
    # routed rows over 4 experts of width 18,944 at d 3584
    (flops.moe_gateup_bound(10558, 3584, 18944, 4), 2.867354140672e12, 1.562025984e9,
     2.8992, "operations"),
    (flops.moe_down_bound(10558, 3584, 18944, 4), 1.433677070336e12, 1.018863616e9,
     1.4496, "operations"),
    (flops.moe_route_bound(7424, 3584, 5, 2, 10558), 0.0, 440.536084e6, 0.1315, "bytes"),
]


@pytest.mark.parametrize("case", range(len(MAIN_PATH)))
def test_kernel_bounds_at_main_path_shapes(case):
    bound, ops, nbytes, ms, by = MAIN_PATH[case]
    assert bound.flops + bound.f32_flops == pytest.approx(ops, rel=1e-12)
    assert bound.bytes == pytest.approx(nbytes, rel=1e-12)
    assert round(bound.bound_ms, 4) == ms
    assert bound.bound_by == by
    assert bound.bound_s == max(bound.flops_s, bound.bytes_s)


@pytest.mark.parametrize("n_mels,nnz", [(80, 391), (128, 394)])
def test_log_mel_bound_counts_three_bf16_products(n_mels, nnz):
    """Kernel #1's bound is the contract's recipe on the tensor cores: three
    bf16 limb products of the (400, 402) DFT against the bf16 peak, then the
    mel projection once in f32 over the bank's nonzero weights against the
    f32 peak; the bytes are the f32 audio in and log-mel out."""
    bound = flops.log_mel_bound(32, n_mels)
    dft = flops.mel_flops(n_mels) - 2.0 * 3000 * 201 * n_mels
    assert bound.dtype == "bf16"
    assert bound.flops == 3 * 32 * dft
    assert bound.f32_flops == 32 * 2.0 * 3000 * nnz
    assert bound.flops_s == bound.flops / 989e12 + bound.f32_flops / 67e12
    assert bound.bytes == 4.0 * 32 * (480000 + n_mels * 3000)


def test_topk_forward_bound_counts_the_selected_entries():
    """The decodes count what the data selected, 2·d_in a selected entry."""
    base = flops.topk_sae_forward_bound(100, 64, 512, 8, 16)
    fewer = flops.topk_sae_forward_bound(100, 64, 512, 8, 16, selected=1000)
    assert base.flops - fewer.flops == 2.0 * 64 * (100 * 24 - 1000)
    assert base.bytes == fewer.bytes


def test_flops_module_imports_no_jax():
    tree = ast.parse(Path(flops.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "freud_tpu")]
