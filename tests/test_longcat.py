"""LongCat-Flash-Omni's audio path (``freud_tpu_torch/models/longcat``)
against the plain float32 reference (``longcat_reference.py``,
byte-identical to ``portbench/reference/longcat.py``) at toy widths on the
CPU: d 64, 4 heads with q/kv latents of 32/16, qk 8 + 4 and v 8, dense FFNs
of 48, 8 routed experts of 16 and 4 identity entries, top 3. The JAX
package has no such model; the reference is this model's oracle.

Tolerances: the program in float32 runs the same operations as the
reference in another order (SDPA against written-out attention, W_qa and
W_kva as one product, the routed rows gathered by expert, the softmax's sum
in the kernel's lane order), so each layer's output lies within 1e-5 of the
largest value, the router's probabilities within 1e-6, and the routes are
equal wherever the reference's margin at the top-k boundary is above 1e-4
of the scores' spread (the test says how many are).
"""

import math
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import longcat_reference as ref
from longcat_toy import checkpoint, config
from freud_tpu_torch import profiling
from freud_tpu_torch.models import audio_lm_runtime
from freud_tpu_torch.models.longcat import (
    LongCatConfig,
    LongCatRuntime,
    model_from_state_dict,
)
from freud_tpu_torch.models.omni import OmniRuntime, read_checkpoint, save_checkpoint
from freud_tpu_torch.ops import moe

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: under the test run's parallel
    workers, torch's full-width thread pool on each makes these toy
    forwards crawl. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav(path, seconds, seed):
    audio = np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


def _taps(layers):
    names = ["lm.embed", "omni.projector"]
    for i in range(layers):
        p = f"lm.layers.{i}"
        names += [p, f"{p}.mlp.input", f"{p}.mlp.router", f"{p}.mlp.route"]
    return names


def _close(got, want, rel=1e-5):
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


def _seq(cfg):
    return (len(cfg["audio_prompt"]["prefix_ids"]) + cfg["audio_tokens"]
            + len(cfg["audio_prompt"]["suffix_ids"]))


def test_longcat_reference_copies_are_byte_identical():
    assert ((REPO / "tests" / "longcat_reference.py").read_bytes()
            == (REPO / "portbench" / "reference" / "longcat.py").read_bytes())


@pytest.mark.parametrize("seed,held", [(0, (0, 8)), (1, (2, 5)), (2, (0, 8))])
def test_longcat_audio_path_matches_reference(seed, held):
    """Tower, projector, prompt and two double layers, the whole share held
    and a part of it."""
    cfg = config(layers=2, held=held)
    sd, refw = checkpoint(cfg, seed)
    model = model_from_state_dict(cfg, sd, "cpu", torch.float32)
    mels = torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        out, caps = model(mels, capture=_taps(2))
    enc = ref.tower(refw["tower"], cfg["audio_tower"], mels)
    audio = ref.audio_tokens(enc, refw["model.audio_projector.weight"],
                             refw["model.audio_projector.bias"], 4, 375)
    assert _close(caps["omni.projector"], audio)
    emb = refw["model.embed_tokens.weight"]
    pre, post = cfg["audio_prompt"]["prefix_ids"], cfg["audio_prompt"]["suffix_ids"]
    x = torch.cat([emb[pre].expand(2, -1, -1), audio, emb[post].expand(2, -1, -1)], dim=1)
    assert _close(caps["lm.embed"], x)
    clear = 0
    for i in range(2):
        p = f"lm.layers.{i}"
        x_in = caps["lm.embed" if i == 0 else f"lm.layers.{i - 1}"]
        r = ref.layer(refw["layers"][i], cfg, x_in)
        assert _close(caps[f"{p}.mlp.input"].reshape(r["u"].shape), r["u"])
        assert float((caps[f"{p}.mlp.router"] - r["probs"]).abs().max()) <= 1e-6
        ok = r["margin"] > 1e-4
        clear += int(ok.sum())
        got = torch.sort(caps[f"{p}.mlp.route"].long(), 1).values
        assert torch.equal(got[ok], torch.sort(r["sel"], 1).values[ok])
        assert _close(caps[p], r["out"])
        # identity entries, held experts and experts another card holds all occur
        n_routed = cfg["deployment"]["n_routed_experts"]
        assert bool((r["sel"] >= n_routed).any())
        if held != (0, 8):
            assert bool(((r["sel"] < held[0]) | ((r["sel"] >= held[1])
                                                  & (r["sel"] < n_routed))).any())
    assert clear >= 0.99 * 2 * 2 * _seq(cfg)
    assert torch.equal(out, caps["lm.layers.1"])


@pytest.mark.parametrize("shares", [((0, 2), (2, 4), (4, 6), (6, 8)), ((0, 4), (4, 8)),
                                    ((0, 1), (1, 7), (7, 8))])
def test_longcat_shares_add_up_to_the_uncut_layer(shares):
    """Each card of a deployment holds a share of the routed experts and
    computes the rest of the layer alike: the program's outputs at every
    share, the part every card computes (the reference with no routed expert
    held: attention, dense FFNs, identity entries) counted once, add up to
    the reference's uncut layer."""
    cfg = config(layers=1)
    _, refw = checkpoint(cfg, 11)
    x = torch.randn(1, _seq(cfg), 64, generator=torch.Generator().manual_seed(3))
    outs = []
    for held in shares:
        sd, _ = checkpoint(config(layers=1, held=held), 11)
        model = model_from_state_dict(config(layers=1, held=held), sd, "cpu", torch.float32)
        with torch.no_grad():
            _, caps = model(torch.zeros(1, 80, 3000), capture=["lm.layers.0"],
                            substitute={"lm.embed": x})
        outs.append(caps["lm.layers.0"])
    common = ref.layer(refw["layers"][0], cfg, x, held=(0, 0))["out"]
    uncut = ref.layer(refw["layers"][0], cfg, x)
    total = sum(outs) - (len(shares) - 1) * common
    assert _close(total, uncut["out"])
    # the reference's own parts add up alike, and the identity part is there
    parts = [ref.layer(refw["layers"][0], cfg, x, held=h)["moe"]["held"] for h in shares]
    assert _close(sum(parts), uncut["moe"]["held"])
    assert float(uncut["moe"]["identity"].abs().max()) > 0


def test_longcat_shortcut_lands_at_the_end_of_the_double_layer():
    """The ScMoE order: the program matches the reference, and adding the
    MoE's output before the second attention instead fails the comparison."""
    cfg = config(layers=1)
    sd, refw = checkpoint(cfg, 5)
    model = model_from_state_dict(cfg, sd, "cpu", torch.float32)
    x = torch.randn(2, _seq(cfg), 64, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        _, caps = model(torch.zeros(2, 80, 3000), capture=["lm.layers.0"],
                        substitute={"lm.embed": x})
    w, eps = refw["layers"][0], cfg["rms_norm_eps"]
    r = ref.layer(w, cfg, x)
    assert _close(caps["lm.layers.0"], r["out"])
    # the shortcut moved: h2 + m feeds the second attention and FFN
    cos, sin = ref.rope(x.shape[1], 4, 1e7, "cpu")
    h1 = x + ref.mla(w, cfg, 0, ref.rms_norm(x, w["input_layernorm.0.weight"], eps), cos, sin)
    u = ref.rms_norm(h1, w["post_attention_layernorm.0.weight"], eps)
    h2 = h1 + ref.swiglu(u, *(w[f"mlps.0.{n}_proj.weight"] for n in ("gate", "up", "down")))
    h2 = h2 + r["moe"]["m"].reshape(x.shape)
    h3 = h2 + ref.mla(w, cfg, 1, ref.rms_norm(h2, w["input_layernorm.1.weight"], eps), cos, sin)
    moved = h3 + ref.swiglu(ref.rms_norm(h3, w["post_attention_layernorm.1.weight"], eps),
                            *(w[f"mlps.1.{n}_proj.weight"] for n in ("gate", "up", "down")))
    assert not _close(caps["lm.layers.0"], moved, rel=1e-3)


def test_longcat_route_topk_rule_edges():
    """The biased top-k: the bias chooses and does not weigh, ties go to
    the lower index, each slot's class follows the held and identity
    ranges; the plain version equals the reference's selection."""
    logits = torch.tensor([[2.0, 1.0, 1.0, 0.5, 3.0, 0.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                           [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.5, 0.0, -0.5])
    probs, sel, wsel, cls = moe.route_topk(logits, bias, 2, 6.0, (1, 3), (4, 6))
    assert torch.allclose(probs, torch.softmax(logits, -1), atol=1e-7)
    # row 0: p + b orders 4, 3 (0.5 lifts it over 0, 1 and 2), then 0; row 1:
    # 3, then the tie of 0, 1, 2, 4 to 0; row 2: 3 (lifted) over 4 over 5
    assert sel.tolist() == [[4, 3], [3, 0], [3, 4]]
    assert torch.equal(wsel, 6.0 * probs.gather(1, sel.long()))
    assert cls.tolist() == [[1, 2], [2, 2], [2, 1]]
    rsel, margin = ref.route(probs + bias, 2)
    assert torch.equal(rsel, sel.long())
    assert margin[1] == 0 and margin[0] > 0  # row 1 chose 0 over 1 on a tie
    held = moe.route_topk(logits, bias, 3, 6.0, (0, 4), (4, 6))[3]
    assert held.tolist() == [[1, 0, 0], [0, 0, 0], [0, 1, 1]]


def test_longcat_softmax_sums_in_the_kernels_lane_order():
    """``route_topk_plain``'s sum is the kernel's (lanes of 32, then a
    butterfly), at most an ulp or two from ``torch.softmax``'s."""
    logits = torch.randn(64, 768, generator=torch.Generator().manual_seed(1)) * 3
    e = torch.exp(logits - logits.max(-1, keepdim=True).values)
    lanes = torch.zeros(64, 32)
    for c in range(768):
        lanes[:, c % 32] += e[:, c]
    s = lanes.clone()
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, torch.arange(32) ^ o]
    probs = moe.route_topk_plain(logits, torch.zeros(768), 12, 6.0, (0, 16), (512, 768))[0]
    assert torch.equal(probs, e / s[:, :1])
    assert float(((probs - torch.softmax(logits, -1)).abs() / probs).max()) < 1e-6


def test_longcat_plan_and_combine_with_held_and_identity_ranges():
    """Held experts [2, 4) of 6 routed, identity entries [6, 8): every entry
    counted, only held slots laid out (slot order within an expert), the
    identity slots' weight times u in the combine, absent ones dropped."""
    sel = torch.tensor([[2, 6, 0], [3, 2, 7], [5, 6, 3], [2, 1, 4]], dtype=torch.int32)
    counts = torch.zeros(8, dtype=torch.int32)
    offsets, pos = moe.plan(sel, 2, counts, 2)
    assert counts.tolist() == [1, 1, 3, 2, 1, 1, 2, 1]
    assert offsets.tolist() == [0, 3]
    assert pos.tolist() == [[0, -1, -1], [3, 1, -1], [-1, -1, 4], [2, -1, -1]]
    g = torch.Generator().manual_seed(0)
    u = torch.randn(4, 8, generator=g)
    x, fixed = torch.randn(4, 8, generator=g), torch.randn(4, 8, generator=g)
    y = torch.randn(12, 8, generator=g)
    wsel = torch.rand(4, 3, generator=g)
    out = moe.combine(x, fixed, y, pos, wsel, u, sel, (6, 8))
    want = x + fixed
    for t in range(4):
        for j in range(3):
            e = int(sel[t, j])
            if 2 <= e < 4:
                want[t] += wsel[t, j] * y[pos[t, j]]
            elif e >= 6:
                want[t] += wsel[t, j] * u[t]
    assert torch.allclose(out, want, atol=1e-6)
    # without an identity range the combine is Uni-MoE's, bit for bit
    assert torch.equal(moe.combine(x, fixed, y, pos, wsel),
                       moe.combine_plain(x, fixed, y, pos, wsel))
    assert not torch.allclose(moe.combine(x, fixed, y, pos, wsel), out)


def test_longcat_held_products_read_the_held_counts():
    """``gateup``/``down`` with ``lo``: held expert e's rows are counted at
    counts[lo + e]; the products equal the reference's SwiGLU a row."""
    g = torch.Generator().manual_seed(2)
    d, width = 16, 8
    counts = torch.tensor([5, 2, 0, 3], dtype=torch.int32)  # held [1, 3): 2 and 0 rows
    offsets = torch.tensor([0, 2], dtype=torch.int32)
    a = torch.randn(6, d, generator=g)
    wg, wu = torch.randn(2, width, d, generator=g), torch.randn(2, width, d, generator=g)
    wd = torch.randn(2, d, width, generator=g)
    y = moe.down(moe.gateup(a, counts, offsets, wg, wu, 1), counts, offsets, wd, 1)
    want = ref.swiglu(a[:2], wg[0], wu[0], wd[0])
    assert torch.allclose(y[:2], want, atol=1e-5) and not bool(y[2:].any())


def test_longcat_config_states_the_share():
    cfg = LongCatConfig.from_hf(config(held=(2, 5)))
    assert cfg.n_router == 12 and cfg.identity == (8, 12) and cfg.n_held == 3
    assert cfg.q_scale == pytest.approx(math.sqrt(2)) and cfg.kv_scale == 2.0
    assert cfg.pool == 4 and cfg.seq_len == 380
    bad = config(held=(2, 5))
    bad["n_routed_experts"] = 4
    with pytest.raises(ValueError, match="held experts"):
        LongCatConfig.from_hf(bad)
    whole = config()
    del whole["deployment"]
    assert LongCatConfig.from_hf(whole).held == (0, 8)


def test_longcat_runtime_stops_at_the_tap_and_counts(tmp_path, monkeypatch):
    cfg = config(layers=3, held=(0, 4))
    sd, _ = checkpoint(cfg, 6)
    save_checkpoint(tmp_path / "longcat-flash-omni", cfg, sd)
    monkeypatch.setenv("FREUD_LONGCAT_DIR", str(tmp_path))
    assert audio_lm_runtime("longcat-flash-omni") is LongCatRuntime
    assert audio_lm_runtime(str(tmp_path / "longcat-flash-omni")) is LongCatRuntime
    assert audio_lm_runtime("uni-moe-2.0-omni") is OmniRuntime
    assert audio_lm_runtime("tiny") is None
    rt = LongCatRuntime("longcat-flash-omni", "lm.layers.1", compute_dtype=torch.float32,
                        device="cpu")
    assert len(rt.model.layers) == 2 and rt.activation_width == 64
    assert rt.activation_frames == 375 and rt.COUNTER == "longcat.routes"
    acts, n = rt.activations_with_lengths(torch.randn(2, 80, 3000))
    assert acts.shape == (2, 375, 64) and n.tolist() == [375, 375]
    assert rt.activation_length(16000 * 7) == 88 and rt.activation_length(16000 * 31) == 375
    table = rt.counters()
    assert table.shape == (2, 12)
    assert table.sum(1).tolist() == [2 * _seq(cfg) * 3] * 2  # every slot, held or not
    with pytest.raises(ValueError, match="LongCat-Flash-Omni"):
        LongCatRuntime("longcat-flash-omni", "decoder.blocks.0", device="cpu")


def test_longcat_checkpoint_round_trips(tmp_path):
    cfg = config(layers=1, held=(1, 3))
    sd, _ = checkpoint(cfg, 4)
    sd = {k: (v if "mlp.router" in k else v.bfloat16()) for k, v in sd.items()}
    save_checkpoint(tmp_path / "ckpt", cfg, sd)
    got_cfg, got = read_checkpoint(tmp_path / "ckpt")
    a = model_from_state_dict(cfg, dict(sd), "cpu", torch.float32)
    b = model_from_state_dict(got_cfg, got, "cpu", torch.float32)
    mels = torch.randn(1, 80, 3000)
    with torch.no_grad():
        assert torch.equal(a(mels)[0], b(mels)[0])
    assert not got  # the loader took every tensor out of the dict


@pytest.mark.parametrize("sae", [False, True])
def test_longcat_collection_by_name_writes_a_readable_store(tmp_path, monkeypatch, sae):
    """``get_activations`` with ``longcat-flash-omni`` at ``lm.layers.1`` over
    four WAVs (one short): a store the port's reader reads, one
    ``longcat.routes`` reading a batch over every router entry."""
    from freud_tpu_torch.data.store import ActivationStoreReader
    from freud_tpu_torch.scripts.collect_activations import get_activations

    cfg = config(layers=2, held=(0, 4))
    sd, _ = checkpoint(cfg, 7)
    save_checkpoint(tmp_path / "models" / "longcat-flash-omni", cfg, sd)
    monkeypatch.setenv("FREUD_LONGCAT_DIR", str(tmp_path / "models"))
    audio = tmp_path / "audio"
    audio.mkdir()
    for i, secs in enumerate((30.0, 7.3, 30.0, 3.0)):
        _wav(audio / f"clip{i}.wav", secs, i)
    sae_path = None
    if sae:
        d, n_dict = 64, 256
        g = torch.Generator().manual_seed(0)
        enc = (torch.rand(n_dict, d, generator=g) * 2 - 1) / math.sqrt(d)
        sae_path = tmp_path / "sae.pth"
        torch.save({"model": {"encoder.weight": enc, "encoder.bias": torch.zeros(n_dict),
                              "W_dec": enc.clone(), "b_dec": torch.zeros(d)},
                    "hparams": {"autoencoder_variant": "topk",
                                "autoencoder_config": {"expansion_factor": 4, "k": 4,
                                                       "normalize_decoder": True,
                                                       "multi_topk": False,
                                                       "auxk_alpha": 0.03125,
                                                       "dead_feature_threshold": 1e6},
                                "activation_size": d}}, sae_path)
    profiling.reset()
    stats = get_activations(str(audio), "lm.layers.1", "longcat-flash-omni",
                            str(sae_path) if sae else None, batch_size=3,
                            out_folder=str(tmp_path / "store"), verbose=False, device="cpu")
    assert stats["n_files"] == 4
    reader = ActivationStoreReader(tmp_path / "store", "lm.layers.1")
    assert len(reader) == 4
    assert reader.activation_type == ("indexed" if sae else "tensor")
    assert reader.tensor_shape == ((375, 4) if sae else (375, 64))
    assert list(reader.n_frames) == [375, 92, 375, 38]
    tables = profiling.counter_values("longcat.routes")
    assert len(tables) == 2 and tables[0].shape == (2, 12)
    assert int(tables[1][0].sum()) == 1 * _seq(cfg) * 3
    assert profiling.counter_values("moe.tokens") == []


def test_longcat_fly_loader_takes_weights_in_memory():
    """``model_weights=(hf_config, state_dict)`` with LongCat's model_type
    builds the LongCat runtime (the benchmark's entry)."""
    from freud_tpu_torch.data.loaders import FlyActivationLoader

    cfg = config(layers=1, held=(0, 2))
    sd, _ = checkpoint(cfg, 9)
    loader = FlyActivationLoader(str(REPO / "freud_tpu_torch" / "assets"), "longcat-flash-omni",
                                 None, "lm.layers.0", 2, device="cpu", model_weights=(cfg, sd))
    assert isinstance(loader.runtime, LongCatRuntime)
    assert loader.activation_shape == (375, 64)
    with pytest.raises(ValueError, match="LongCat-Flash-Omni collects on one card"):
        FlyActivationLoader(str(REPO), "longcat-flash-omni", None, "lm.layers.0", 2,
                            device="cpu", shard=(0, 2), model_weights=(cfg, dict(sd)))
