"""LongCat-Flash-Omni's MoE kernels (``csrc/moe.cu``: the biased top-k
route, the plan and combine with held and identity ranges, the grouped
products over a share of the experts) against their plain versions, and the
toy model on a card against the plain reference. Every test is marked
``cuda`` and skips without one (a CUDA kernel has no CPU mode);
``tests/test_longcat.py`` holds the model against the reference on the CPU.

    python -m pytest --noconftest -p no:cacheprovider tests/test_longcat_card.py

Tolerances: the route's probabilities within 2e-7 of the plain version's
relative to each value (both sum in the kernel's lane order; only ``expf``
may differ by an ulp), its selection, weights and classes bit-equal to the
plain rule applied to the kernel's own probabilities (ties included: rows
of equal logits); plan, permute and combine bit for bit; the grouped
products within 1e-2 of the plain bf16 products' largest value (one or two
bf16 ulps: sums in another order); the toy model in bf16 against the f32
reference within 5% of the layer's update in RMS (bf16 products and
residual stream).
"""

import math

import pytest
import torch

from freud_tpu_torch.ops import moe

pytestmark = pytest.mark.cuda

N_ROUTED, N_ZERO, TOP_K, SCALE = 512, 256, 12, 6.0
HELD, IDENT = (0, 16), (512, 768)


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _logits(tokens, gen, dev, ties=False):
    logits = torch.randn(tokens, N_ROUTED + N_ZERO, generator=gen, device=dev) * 2.0
    if ties:  # equal logits in blocks of 4 entries: equal p, equal p + b
        logits = logits[:, ::4].repeat_interleave(4, dim=1).contiguous()
    return logits


@pytest.mark.parametrize("tokens,ties", [(13024, False), (1037, True), (64, False)])
def test_route_topk_matches_plain(tokens, ties):
    _skip_without_card()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(tokens)
    logits = _logits(tokens, gen, dev, ties)
    bias = torch.randn(N_ROUTED + N_ZERO, generator=gen, device=dev) * 1e-3
    if ties:
        bias = torch.zeros_like(bias)
    probs, sel, wsel, cls = moe.route_topk(logits, bias, TOP_K, SCALE, HELD, IDENT)
    p_probs = moe.route_topk_plain(logits, bias, TOP_K, SCALE, HELD, IDENT)[0]
    assert float(((probs - p_probs).abs() / p_probs).max()) <= 2e-7
    want = moe.select_topk(probs, bias, TOP_K, SCALE, HELD, IDENT)
    for got, w in zip((sel, wsel, cls), want):
        assert torch.equal(got, w)
    if ties:  # a tie inside the top 12 goes to the lower index
        assert bool((sel[:, 1:] > sel[:, :-1]).any())
    assert torch.equal(cls, torch.where(sel < 16, 0, torch.where(sel >= 512, 1, 2)).to(
        torch.int8))


def _weights(gen, dev, n, d, width):
    def u(*shape, fan):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) / fan ** 0.5).bfloat16()

    return (u(n, width, d, fan=d), u(n, width, d, fan=d), u(n, d, width, fan=width))


def _grouped_close(got, want, rows):
    scale = float(want[rows].abs().max())
    assert float((got[rows].float() - want[rows].float()).abs().max()) <= 1e-2 * scale


def test_held_share_kernels_at_the_cell_shapes():
    """The cell's MoE: 13,024 tokens at d 6,144, 768 router entries, top 12,
    16 held experts of 2,048 (~200 rows each), 256 identity entries."""
    _skip_without_card()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    tokens, d, width = 13024, 6144, 2048
    logits = _logits(tokens, gen, dev)
    bias = torch.randn(768, generator=gen, device=dev) * 1e-3
    probs, sel, wsel, _ = moe.route_topk(logits, bias, TOP_K, SCALE, HELD, IDENT)
    counts = torch.zeros(768, dtype=torch.int32, device=dev)
    p_counts = counts.clone()
    offsets, pos = moe.plan(sel, 16, counts, 0)
    p_offsets, p_pos = moe.plan_plain(sel, 16, p_counts, 0)
    assert torch.equal(counts, p_counts) and torch.equal(offsets, p_offsets)
    assert torch.equal(pos, p_pos)
    assert int(counts.sum()) == tokens * TOP_K
    held = int(counts[:16].sum())
    assert 100 * 16 < held < 400 * 16, held
    u = (torch.randn(tokens, d, generator=gen, device=dev) * 0.5).bfloat16()
    rows_max = tokens * TOP_K
    a = moe.permute(u, pos, rows_max)
    assert torch.equal(a[:held], moe.permute_plain(u, pos, rows_max)[:held])
    w_gate, w_up, w_down = _weights(gen, dev, 16, d, width)
    rows = torch.arange(held, device=dev)
    h = moe.gateup(a, counts, offsets, w_gate, w_up)
    p_h = moe.gateup_plain(a, counts, offsets, w_gate, w_up)
    _grouped_close(h, p_h, rows)
    y = moe.down(p_h, counts, offsets, w_down)
    _grouped_close(y, moe.down_plain(p_h, counts, offsets, w_down), rows)
    x, fixed = u.flip(0).contiguous(), (u * 0.25).contiguous()
    out = moe.combine(x, fixed, y, pos, wsel, u, sel, IDENT)
    assert torch.equal(out.view(torch.int16),
                       moe.combine_plain(x, fixed, y, pos, wsel, u, sel, IDENT).view(torch.int16))
    # a share elsewhere in the router: experts [496, 512) take the same path
    counts2 = torch.zeros(768, dtype=torch.int32, device=dev)
    offsets2, pos2 = moe.plan(sel, 16, counts2, 496)
    p_off2, p_pos2 = moe.plan_plain(sel, 16, counts2.clone(), 496)
    assert torch.equal(offsets2, p_off2) and torch.equal(pos2, p_pos2)


def test_one_share_products_are_the_rows_of_the_whole_call():
    """Uni-MoE's call (every expert held, no identity range) at its cell's
    shapes equals the plain versions, and a share [lo, hi) of the same
    experts computes their rows bit for bit as the whole call does: the held
    range moves which tiles run, not what a tile computes."""
    _skip_without_card()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(3)
    tokens, d, width, n_dyn = 7424, 3584, 18944, 4
    u = torch.randn(tokens, d, generator=gen, device=dev).bfloat16()
    w_router = torch.randn(n_dyn + 1, d, generator=gen, device=dev) * 1.5 / d ** 0.5
    probs, sel, wsel = moe.route(u, w_router, 0.7, 2)
    counts = torch.zeros(n_dyn + 1, dtype=torch.int32, device=dev)
    p_counts = counts.clone()
    offsets, pos = moe.plan(sel, n_dyn, counts)
    assert [torch.equal(a, b) for a, b in
            zip((offsets, pos), moe.plan_plain(sel, n_dyn, p_counts))] == [True, True]
    assert torch.equal(counts, p_counts)
    a = moe.permute(u, pos, tokens * 2)
    w_gate, w_up, w_down = _weights(gen, dev, n_dyn, d, width)
    h = moe.gateup(a, counts, offsets, w_gate, w_up)
    routed = int(counts[:n_dyn].sum())
    _grouped_close(h, moe.gateup_plain(a, counts, offsets, w_gate, w_up),
                   torch.arange(routed, device=dev))
    y = moe.down(h, counts, offsets, w_down)
    fixed = torch.randn(tokens, d, generator=gen, device=dev).bfloat16()
    out = moe.combine(u, fixed, y, pos, wsel)
    assert torch.equal(out.view(torch.int16),
                       moe.combine_plain(u, fixed, y, pos, wsel).view(torch.int16))
    # experts 2 and 3 alone: plan's offsets are theirs, the rows theirs
    c2 = torch.zeros_like(counts)
    off2, pos2 = moe.plan(sel, 2, c2, 2)
    a2 = moe.permute(u, pos2, tokens * 2)
    h2 = moe.gateup(a2, c2, off2, w_gate[2:].contiguous(), w_up[2:].contiguous(), 2)
    y2 = moe.down(h2, c2, off2, w_down[2:].contiguous(), 2)
    first = int(offsets[2])
    n2 = int(counts[2:4].sum())
    assert torch.equal(h2[:n2].view(torch.int16), h[first:first + n2].view(torch.int16))
    assert torch.equal(y2[:n2].view(torch.int16), y[first:first + n2].view(torch.int16))


def test_longcat_toy_model_on_the_card_against_the_reference():
    """A toy LongCat at widths the kernels take (d 512, 4 heads with latents
    of 128/64, qk 64 + 32, v 64, experts of 256, 32 routed over a share
    [8, 24) and 16 identity entries, top 6): the bf16 forward, once under
    ``set_sync_debug_mode("error")``, against the f32 reference layer by
    layer on the program's own inputs."""
    _skip_without_card()
    import longcat_reference as ref
    from longcat_toy import TOWER, checkpoint, config

    from freud_tpu_torch.models.longcat import model_from_state_dict

    tower = {**TOWER, "n_audio_state": 256, "n_text_state": 256, "n_audio_head": 4}
    cfg = config(layers=2, d=512, heads=4, q_lora=128, kv_lora=64, nope=64, rope=32, v=64,
                 ffn=384, width=256, n_routed=32, n_zero=16, top_k=6, held=(8, 24),
                 tower=tower)
    sd, refw = checkpoint(cfg, 1)
    dev = torch.device("cuda")
    model = model_from_state_dict(cfg, {k: v.to(dev) for k, v in sd.items()}, dev,
                                  torch.bfloat16)
    mels = torch.randn(4, tower["n_mels"], 3000, device=dev)
    names = ["lm.embed"] + [n for i in range(2) for n in (f"lm.layers.{i}",
                                                           f"lm.layers.{i}.mlp.route")]
    with torch.inference_mode():
        model(mels)  # warm: the kernels build, cuBLAS and SDPA pick their kernels
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, caps = model(mels, capture=names)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.backends.cuda.matmul.allow_tf32 = False
    seq = model.cfg.seq_len
    assert model.routes.sum(1).tolist() == [4 * seq * 6] * 2
    for i in range(2):
        w = {k: v.to(dev) for k, v in refw["layers"][i].items()}
        x_in = caps["lm.embed" if i == 0 else f"lm.layers.{i - 1}"].float()
        r = ref.layer(w, cfg, x_in)
        got = caps[f"lm.layers.{i}.mlp.route"].long()
        keep = (torch.sort(got, 1).values == torch.sort(r["sel"], 1).values).all(1)
        keep = keep.reshape(x_in.shape[:2])
        gap = (caps[f"lm.layers.{i}"].float() - r["out"])[keep]
        update = (r["out"] - x_in)[keep]
        assert float(keep.float().mean()) > 0.9
        assert math.sqrt(float(gap.pow(2).mean()) / float(update.pow(2).mean())) < 0.05

