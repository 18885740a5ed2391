"""Uni-MoE-2.0-Omni's audio path (``freud_tpu_torch/models/omni``) against
the plain float32 reference (``omni_reference.py``, byte-identical to
``portbench/reference/omni.py``) at toy widths on the CPU: d 64, 4 query
heads over 2 KV heads, 4 dynamic experts of width 16 and a null one, 2 fixed
experts of width 8. The JAX package has no such model; the reference is
this model's oracle.

Tolerances: the program in float32 runs the same operations as the
reference in another order (SDPA against written-out attention, the fixed
experts as one SwiGLU of their summed width, the routed rows gathered by
expert), so each layer's output lies within 1e-5 of the largest value
(f32 rounding over sums of 64 to 32 terms), the router's probabilities
within 1e-6, and the routes are equal wherever no decision lies within
1e-5 (the toy weights leave every margin above 1e-5: the test says so).
"""

import math
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import omni_reference as ref
from omni_toy import checkpoint, config
from freud_tpu_torch import profiling
from freud_tpu_torch.models.omni import (
    OmniConfig,
    OmniRuntime,
    model_from_state_dict,
    read_checkpoint,
    save_checkpoint,
)
from freud_tpu_torch.models.omni import model as omni_model
from freud_tpu_torch.ops import moe

REPO = Path(__file__).resolve().parents[1]


def _wav(path, seconds, seed):
    audio = np.random.default_rng(seed).standard_normal(int(16000 * seconds)) * 0.1
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


def _model(cfg, seed=0, dtype=torch.float32):
    sd, refw = checkpoint(cfg, seed)
    return model_from_state_dict(cfg, sd, "cpu", dtype), refw


def _taps(layers):
    names = ["lm.embed", "omni.projector"]
    for i in range(layers):
        p = f"lm.layers.{i}"
        names += [p, f"{p}.post_attention_layernorm", f"{p}.mlp.router", f"{p}.mlp.route"]
    return names


def test_omni_reference_copies_are_byte_identical():
    assert ((REPO / "tests" / "omni_reference.py").read_bytes()
            == (REPO / "portbench" / "reference" / "omni.py").read_bytes())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_omni_layers_match_reference(seed):
    cfg = config(layers=2)
    model, refw = _model(cfg, seed)
    mels = torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        out, caps = model(mels, capture=_taps(2))
    enc = ref.tower(refw["tower"], cfg["audio_tower"], mels)
    audio = ref.audio_tokens(enc, refw["model.audio_projector.weight"],
                             refw["model.audio_projector.bias"], 5, 200)
    assert torch.allclose(caps["omni.projector"], audio, atol=1e-5 * float(audio.abs().max()))
    emb = refw["model.embed_tokens.weight"]
    pre, post = cfg["audio_prompt"]["prefix_ids"], cfg["audio_prompt"]["suffix_ids"]
    x = torch.cat([emb[pre].expand(2, -1, -1), audio, emb[post].expand(2, -1, -1)], dim=1)
    assert torch.allclose(caps["lm.embed"], x, atol=1e-5 * float(x.abs().max()))
    for i in range(2):
        p = f"lm.layers.{i}"
        x_in = caps["lm.embed" if i == 0 else f"lm.layers.{i - 1}"]
        r = ref.layer(refw["layers"][i], cfg, x_in)
        assert float(r["margin"].min()) > 1e-5
        assert torch.equal(torch.sort(caps[f"{p}.mlp.route"].long(), 1).values,
                           torch.sort(r["sel"], 1).values)
        assert float((caps[f"{p}.mlp.router"] - r["probs"]).abs().max()) <= 1e-6
        assert float((caps[p] - r["out"]).abs().max()) <= 1e-5 * float(r["out"].abs().max())
        # one expert and two both occur, and the null expert is chosen
        taken = (r["sel"] >= 0).sum(1)
        assert bool((taken == 1).any()) and bool((taken == 2).any())
        assert bool((r["sel"] == 4).any())
    assert torch.equal(out, caps["lm.layers.1"])


def test_omni_mrope_turns_each_section_by_its_own_axis():
    """Distinct (t, h, w) ids: pair j turns at its section's id times its
    frequency; the sections are (2, 3, 3) pairs of a 16-wide head."""
    hd, theta, sections = 16, 1e6, (2, 3, 3)
    t = torch.arange(5)
    pos = torch.stack([t, 2 * t + 1, 3 * t + 7])[:, None, :]  # (3, b=1, T)
    cos, sin = omni_model.rope_table(pos, hd, theta, sections)
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    axis = [0] * 2 + [1] * 3 + [2] * 3
    angle = torch.stack([pos[axis[j], 0].double() * inv[j] for j in range(hd // 2)], -1)
    angle = torch.cat([angle, angle], -1)
    assert torch.allclose(cos[0].double(), angle.cos(), atol=1e-6)
    assert torch.allclose(sin[0].double(), angle.sin(), atol=1e-6)
    # equal ids: the table is 1-D RoPE's, whatever the sections
    same = torch.stack([t, t, t])[:, None, :]
    c1, _ = omni_model.rope_table(same, hd, theta, sections)
    c2, _ = omni_model.rope_table(same, hd, theta, (4, 2, 2))
    assert torch.equal(c1, c2)
    rc, rs = ref.rope(5, hd, theta, sections, "cpu")
    assert torch.allclose(c1[0], rc, atol=1e-6) and torch.allclose(
        omni_model.rope_table(same, hd, theta, sections)[1][0], rs, atol=1e-6)


def test_omni_top_p_rule_edges():
    # p sorted: 0.8 ≥ 0.7 → one entry; 0.5 + 0.3 → two; ties to the lower index
    probs = torch.tensor([[0.8, 0.1, 0.05, 0.03, 0.02],
                          [0.3, 0.5, 0.1, 0.05, 0.05],
                          [0.25, 0.25, 0.25, 0.125, 0.125],
                          [0.05, 0.05, 0.05, 0.05, 0.8]])
    sel, wsel = moe.select(probs, 0.7, 2)
    assert sel.tolist() == [[0, -1], [1, 0], [0, 1], [4, -1]]
    assert torch.allclose(wsel, torch.tensor([[0.8, 0.0], [0.5, 0.3], [0.25, 0.25],
                                              [0.8, 0.0]]))
    rsel, rwsel, margin = ref.route(probs, 0.7, 2)
    assert torch.equal(rsel, sel.long()) and torch.allclose(rwsel, wsel)
    assert margin[0] == pytest.approx(0.1) and margin[2] == 0.0


@pytest.mark.parametrize("entry", [2, 4])
def test_omni_skewed_routing_drops_no_token(entry):
    """Every token on one dynamic expert (none on the others) or on the null
    expert (only the fixed experts compute): the program equals the
    reference and counts every token."""
    cfg = config(layers=1)
    sd, refw = checkpoint(cfg, 3)
    gen = torch.Generator().manual_seed(5)
    bias = 1.0 + 0.1 * torch.rand(cfg["hidden_size"], generator=gen)
    router = torch.zeros(5, cfg["hidden_size"])
    router[entry] = 50.0 * bias / cfg["hidden_size"]
    sd["model.layers.0.mlp.gate.weight"] = router.clone()
    sd["model.layers.0.post_attention_layernorm.weight"] = torch.ones(cfg["hidden_size"])
    refw["layers"][0]["mlp.gate.weight"] = router.clone()
    refw["layers"][0]["post_attention_layernorm.weight"] = torch.ones(cfg["hidden_size"])
    model = model_from_state_dict(cfg, sd, "cpu", torch.float32)
    x = torch.randn(3, cfg_seq(cfg), cfg["hidden_size"], generator=gen) + 2.0
    with torch.no_grad():
        _, caps = model(torch.zeros(3, 80, 3000),
                        capture=[*_taps(1), "lm.layers.0.self_attn"],
                        substitute={"lm.embed": x})
    r = ref.layer(refw["layers"][0], cfg, x)
    tokens = 3 * cfg_seq(cfg)
    counts = model.moe_tokens[0].tolist()
    assert counts[entry] == tokens and sum(counts) == tokens
    assert bool((r["sel"][:, 0] == entry).all())
    assert float((caps["lm.layers.0"] - r["out"]).abs().max()) <= 1e-5 * float(
        r["out"].abs().max())
    if entry == 4:  # the null expert: h plus the fixed experts alone
        u = caps["lm.layers.0.post_attention_layernorm"].reshape(tokens, -1)
        fixed = sum(ref.swiglu(u, *(refw["layers"][0][f"mlp.fixed_experts.{f}.{p}_proj.weight"]
                                    for p in ("gate", "up", "down"))) for f in range(2))
        h = (x + caps["lm.layers.0.self_attn"]).reshape(tokens, -1)
        assert torch.allclose(caps["lm.layers.0"].reshape(tokens, -1), h + fixed, atol=1e-5)


def cfg_seq(cfg):
    return (len(cfg["audio_prompt"]["prefix_ids"]) + cfg["whisper_query_tokens_size"]
            + len(cfg["audio_prompt"]["suffix_ids"]))


def test_omni_plan_lays_rows_by_expert_in_token_order():
    sel = torch.tensor([[2, 0], [4, -1], [0, 1], [2, -1], [4, 3]], dtype=torch.int32)
    counts = torch.zeros(5, dtype=torch.int32)
    offsets, pos = moe.plan(sel, 4, counts)
    assert counts.tolist() == [2, 1, 2, 1, 2]
    assert offsets.tolist() == [0, 2, 3, 5]
    assert pos.tolist() == [[3, 0], [-1, -1], [1, 2], [4, -1], [-1, 5]]
    u = torch.arange(10.0).reshape(5, 2)
    a = moe.permute(u, pos, 10)
    assert a[:6].tolist() == [[0, 1], [4, 5], [4, 5], [0, 1], [6, 7], [8, 9]]


def test_omni_checkpoint_round_trips(tmp_path):
    cfg = config(layers=2)
    sd, _ = checkpoint(cfg, 4)
    sd = {k: (v.bfloat16() if "gate.weight" not in k else v) for k, v in sd.items()}
    save_checkpoint(tmp_path / "ckpt", cfg, sd)
    got_cfg, got = read_checkpoint(tmp_path / "ckpt")
    assert got_cfg == cfg and set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    a = model_from_state_dict(cfg, dict(sd), "cpu", torch.float32)
    b = model_from_state_dict(got_cfg, got, "cpu", torch.float32)
    mels = torch.randn(1, 80, 3000)
    with torch.no_grad():
        assert torch.equal(a(mels)[0], b(mels)[0])
    assert not got  # the loader took every tensor out of the dict


def test_omni_runtime_stops_at_the_tap_and_counts(tmp_path, monkeypatch):
    cfg = config(layers=3)
    sd, _ = checkpoint(cfg, 6)
    save_checkpoint(tmp_path / "uni-moe-2.0-omni", cfg, sd)
    monkeypatch.setenv("FREUD_OMNI_DIR", str(tmp_path))
    rt = OmniRuntime("uni-moe-2.0-omni", "lm.layers.1", compute_dtype=torch.float32,
                     device="cpu")
    assert len(rt.model.layers) == 2 and rt.activation_width == 64
    assert rt.activation_frames == 200
    acts, n = rt.activations_with_lengths(torch.randn(2, 80, 3000))
    assert acts.shape == (2, 200, 64) and n.tolist() == [200, 200]
    assert rt.activation_length(16000 * 7) == 70 and rt.activation_length(16000 * 25) == 200
    assert rt.activation_length(16000 * 7 + 400) == 71
    taken = rt.counters().sum(1)
    tokens = 2 * OmniConfig.from_hf(cfg).seq_len
    assert bool(((taken >= tokens) & (taken <= 2 * tokens)).all())
    with pytest.raises(ValueError):
        OmniRuntime("uni-moe-2.0-omni", "decoder.blocks.0", device="cpu")


@pytest.mark.parametrize("sae", [False, True])
def test_omni_collection_writes_a_readable_store(tmp_path, monkeypatch, sae):
    """``get_activations`` at ``lm.layers.1`` over four WAVs (one short):
    a store the port's reader reads, one ``moe.tokens`` reading a batch."""
    from freud_tpu_torch.data.store import ActivationStoreReader
    from freud_tpu_torch.models.sae import topk as topk_mod  # noqa: F401
    from freud_tpu_torch.scripts.collect_activations import get_activations

    cfg = config(layers=2)
    sd, _ = checkpoint(cfg, 7)
    save_checkpoint(tmp_path / "models" / "uni-moe-2.0-omni", cfg, sd)
    monkeypatch.setenv("FREUD_OMNI_DIR", str(tmp_path / "models"))
    audio = tmp_path / "audio"
    audio.mkdir()
    for i, secs in enumerate((20.0, 7.3, 20.0, 3.0)):
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
    stats = get_activations(str(audio), "lm.layers.1", "uni-moe-2.0-omni",
                            str(sae_path) if sae else None, batch_size=3,
                            out_folder=str(tmp_path / "store"), verbose=False, device="cpu")
    assert stats["n_files"] == 4
    reader = ActivationStoreReader(tmp_path / "store", "lm.layers.1")
    assert len(reader) == 4
    assert reader.activation_type == ("indexed" if sae else "tensor")
    assert reader.tensor_shape == ((200, 4) if sae else (200, 64))
    assert list(reader.n_frames) == [200, 73, 200, 30]
    tables = profiling.counter_values("moe.tokens")
    assert len(tables) == 2 and tables[0].shape == (2, 5)
    assert int(tables[1][0].sum()) >= 1 * OmniConfig.from_hf(cfg).seq_len


def test_profiling_counters_keep_readings_and_reset():
    profiling.reset()
    with profiling.span("outer"):
        profiling.count("c", np.array([1, 2]))
    profiling.count("c", torch.tensor([3, 4]))
    recs = profiling.counter_records("c")
    assert [r.parent is None for r in recs] == [False, True]
    assert [v.tolist() for v in profiling.counter_values("c")] == [[1, 2], [3, 4]]
    profiling.reset()
    assert profiling.counter_values("c") == []
