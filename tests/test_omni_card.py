"""Uni-MoE-2.0-Omni's MoE kernels (``csrc/moe.cu``) against their plain
versions, and its forward without host synchronisation, on a card. Every
test is marked ``cuda`` and skips without one (a CUDA kernel has no CPU
mode); ``tests/test_omni.py`` holds the model against the plain reference
on the CPU.

    python -m pytest --noconftest -p no:cacheprovider tests/test_omni_card.py

Tolerances: the router's probabilities within 1e-5 of the plain f32
product's (the kernel sums a dot product in another order; p ≤ 1), its
selection equal wherever no entry lies within 1e-5 of a decision; plan,
permute and combine bit for bit (the combine rounds each f32 operation as
the plain version does); the grouped products within 1e-2 of the plain
bf16 products' largest value (both round bf16 products of f32 sums taken
in different orders: one or two bf16 ulps) and rows no expert took left
untouched.
"""

import pytest
import torch

from freud_tpu_torch.ops import moe

pytestmark = pytest.mark.cuda

D, WIDTH, N_DYN, TOP_K = 512, 256, 4, 2


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _weights(gen, dev):
    def u(*shape, fan):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) / fan ** 0.5).bfloat16()

    return (u(N_DYN, WIDTH, D, fan=D), u(N_DYN, WIDTH, D, fan=D), u(N_DYN, D, WIDTH, fan=WIDTH))


def _grouped_close(got, want, rows):
    scale = float(want[rows].abs().max())
    assert float((got[rows].float() - want[rows].float()).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("tokens,skew", [(1037, None), (4096, "one"), (777, "pair"),
                                         (640, "null")])
def test_moe_kernels_match_plain(tokens, skew):
    _skip_without_card()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(tokens)
    u = torch.randn(tokens, D, generator=gen, device=dev).bfloat16()
    w_router = torch.randn(N_DYN + 1, D, generator=gen, device=dev) * 1.5 / D ** 0.5
    probs, sel, wsel = moe.route(u, w_router, 0.7, TOP_K)
    p_probs, p_sel, p_wsel = moe.route_plain(u, w_router, 0.7, TOP_K)
    assert float((probs - p_probs).abs().max()) <= 1e-5
    ps = torch.sort(p_probs, dim=-1, descending=True).values
    clear = ((ps[:, :-1] - ps[:, 1:]).min(1).values > 1e-5) & ((ps[:, 0] - 0.7).abs() > 1e-5)
    assert torch.equal(sel[clear], p_sel[clear])
    assert float((wsel - p_wsel).abs().max()) <= 1e-5
    if skew == "one":     # every token on expert 0 alone
        sel = torch.tensor([0, -1], dtype=torch.int32, device=dev).repeat(tokens, 1)
    elif skew == "pair":  # every token on experts 0 and 1, none on 2 and 3
        sel = torch.tensor([1, 0], dtype=torch.int32, device=dev).repeat(tokens, 1)
    elif skew == "null":  # every token's top entry the null expert
        sel = torch.tensor([N_DYN, 2], dtype=torch.int32, device=dev).repeat(tokens, 1)
    counts = torch.zeros(N_DYN + 1, dtype=torch.int32, device=dev)
    p_counts = counts.clone()
    offsets, pos = moe.plan(sel, N_DYN, counts)
    p_offsets, p_pos = moe.plan_plain(sel, N_DYN, p_counts)
    assert torch.equal(counts, p_counts) and torch.equal(offsets, p_offsets)
    assert torch.equal(pos, p_pos)
    assert int(counts.sum()) == int((sel >= 0).sum())  # no slot dropped
    rows_max = tokens * TOP_K
    routed = int(counts[:N_DYN].sum())
    rows = torch.arange(routed, device=dev)
    a = moe.permute(u, pos, rows_max)
    assert torch.equal(a[:routed], moe.permute_plain(u, pos, rows_max)[:routed])
    w_gate, w_up, w_down = _weights(gen, dev)
    h = moe.gateup(a, counts, offsets, w_gate, w_up)
    p_h = moe.gateup_plain(a, counts, offsets, w_gate, w_up)
    _grouped_close(h, p_h, rows)
    y = moe.down(p_h, counts, offsets, w_down)
    p_y = moe.down_plain(p_h, counts, offsets, w_down)
    _grouped_close(y, p_y, rows)
    fixed = torch.randn(tokens, D, generator=gen, device=dev).bfloat16()
    out = moe.combine(u, fixed, p_y, pos, wsel)
    assert torch.equal(out.view(torch.int16),
                       moe.combine_plain(u, fixed, p_y, pos, wsel).view(torch.int16))


def test_omni_forward_does_not_synchronise():
    """A batch through the whole audio path (tower, projector, two LM layers
    with the MoE kernels) under ``set_sync_debug_mode("error")``, at widths
    the kernels take (d 512, expert width 256)."""
    _skip_without_card()
    from freud_tpu_torch.models.omni import model_from_state_dict
    from omni_toy import TOWER, checkpoint, config

    tower = {**TOWER, "n_audio_state": 256, "n_text_state": 256, "n_audio_head": 4}
    cfg = config(layers=2, d=512, heads=8, kv=2, sections=(8, 12, 12), width=256, fixed=64,
                 tower=tower)
    sd, _ = checkpoint(cfg)
    dev = torch.device("cuda")
    model = model_from_state_dict(cfg, {k: v.to(dev) for k, v in sd.items()}, dev,
                                  torch.bfloat16)
    mels = torch.randn(4, tower["n_mels"], 3000, device=dev)
    with torch.inference_mode():
        model(mels)  # warm: the kernels build, cuBLAS and SDPA pick their kernels
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = model(mels)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.float()).all()
    tokens = 4 * model.cfg.seq_len
    taken = model.moe_tokens.sum(1)
    assert bool(((taken >= tokens) & (taken <= 2 * tokens)).all()), taken


def test_moe_on_the_card_takes_bf16_only():
    """A CUDA tensor never falls back to the plain versions (which read the
    counts on the host): the wrappers raise on float32 or a strided view, and
    the runtime refuses a compute dtype other than bf16 on the card."""
    _skip_without_card()
    from freud_tpu_torch.models.omni import OmniRuntime

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    w_gate, w_up, w_down = _weights(gen, dev)
    u = torch.randn(64, D, generator=gen, device=dev)
    w_router = torch.randn(N_DYN + 1, D, generator=gen, device=dev)
    counts = torch.zeros(N_DYN + 1, dtype=torch.int32, device=dev)
    offsets = torch.zeros(N_DYN, dtype=torch.int32, device=dev)
    pos = torch.full((64, TOP_K), -1, dtype=torch.int32, device=dev)
    wsel = torch.zeros(64, TOP_K, device=dev)
    strided = torch.randn(D, 128, generator=gen, device=dev).bfloat16().T
    calls = [lambda: moe.route(u, w_router, 0.7, TOP_K),
             lambda: moe.route(strided, w_router, 0.7, TOP_K),
             lambda: moe.permute(u, pos, 64 * TOP_K),
             lambda: moe.gateup(u, counts, offsets, w_gate, w_up),
             lambda: moe.gateup(u.bfloat16(), counts, offsets, w_gate.float(), w_up),
             lambda: moe.down(torch.randn(64, WIDTH, device=dev), counts, offsets, w_down),
             lambda: moe.combine(u, u, u, pos, wsel)]
    for call in calls:
        with pytest.raises(ValueError, match="contiguous bf16"):
            call()
    with pytest.raises(ValueError, match="bfloat16"):
        OmniRuntime("uni-moe-2.0-omni", "lm.layers.0", torch.float32, dev)
