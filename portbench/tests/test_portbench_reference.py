"""The plain reference against naive loops at tiny sizes, and the
comparisons on answers known to be right or wrong."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.reference import judge
from portbench.reference import sae as ref_sae
from portbench.reference import whisper as ref_whisper

F64 = torch.float64
HP = {"k": 2, "auxk_alpha": 0.5, "dead_feature_threshold": 3.0, "lr": 0.01, "steps": 100,
      "scheduler": "linear", "num_warmup_steps": 4, "clip_thresh": 1e9}


def _naive_loss(p, x, counters, hp):
    """Row by row, latent by latent."""
    files, t, d = x.shape
    n = p["encoder.weight"].shape[0]
    k, k_aux = hp["k"], d // 2
    mean = [[sum(x[f, i, c] for f in range(files)) / files for c in range(d)] for i in range(t)]
    tv = sum((x[f, i, c] - mean[i][c]) ** 2 for f in range(files) for i in range(t)
             for c in range(d))
    dead = [bool(counters[j] > hp["dead_feature_threshold"]) for j in range(n)]
    n_dead = sum(dead)
    fvu = aux = 0.0
    fired = [False] * n
    for f in range(files):
        for i in range(t):
            row = x[f, i]
            acts = [torch.relu(sum((row[c] - p["b_dec"][c]) * p["encoder.weight"][j, c]
                                   for c in range(d)) + p["encoder.bias"][j]) for j in range(n)]
            order = sorted(range(n), key=lambda j: -float(acts[j].detach()))
            kth = float(acts[order[k - 1]].detach())
            keep = [float(a.detach()) >= kth for a in acts]
            for j in range(n):
                fired[j] |= keep[j] and float(acts[j].detach()) > 0
            y = [sum(acts[j] * p["W_dec"][j, c] for j in range(n) if keep[j]) for c in range(d)]
            e = [y[c] + p["b_dec"][c] - row[c] for c in range(d)]
            fvu = fvu + sum(v * v for v in e)
            if n_dead:
                dead_order = sorted((j for j in range(n) if dead[j]),
                                    key=lambda j: -float(acts[j].detach()))
                t_aux = float(acts[dead_order[min(k_aux, n_dead) - 1]].detach())
                ya = [sum(acts[j] * p["W_dec"][j, c] for j in range(n)
                          if dead[j] and float(acts[j].detach()) >= t_aux) for c in range(d)]
                aux = aux + sum((ya[c] - y[c] + row[c]) ** 2 for c in range(d))
    scale = min(n_dead / k_aux, 1.0)
    return fvu / tv + hp["auxk_alpha"] * scale * aux / tv, fired


@pytest.mark.parametrize("dead_from", [None, 2])
def test_portbench_reference_step_against_naive_loops(dead_from):
    g = torch.Generator().manual_seed(3)
    files, t, d, n = 2, 3, 4, 6
    x = torch.randn(files, t, d, generator=g, dtype=F64) + 0.5
    p = {"encoder.weight": torch.randn(n, d, generator=g, dtype=F64) * 0.5,
         "encoder.bias": torch.randn(n, generator=g, dtype=F64) * 0.1,
         "W_dec": torch.randn(n, d, generator=g, dtype=F64) * 0.5,
         "b_dec": torch.randn(d, generator=g, dtype=F64) * 0.1}
    counters = torch.zeros(n, dtype=torch.int64)
    if dead_from is not None:
        counters[dead_from:] = 10
    zeros = {k: torch.zeros_like(v) for k, v in p.items()}
    out = ref_sae.topk_step(p, zeros, zeros, 2, counters, x, HP, block_rows=4)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss, fired = _naive_loss(leaves, x, counters, HP)
    grads = torch.autograd.grad(loss, [leaves[k] for k in ref_sae.LEAVES])
    assert out["loss"] == pytest.approx(float(loss), rel=1e-9)
    for name, gr in zip(ref_sae.LEAVES, grads):
        torch.testing.assert_close(out["grads"][name], gr, rtol=1e-9, atol=1e-12)
    # Adam's first update at count 2 of a 4-step warm-up: lr 0.005 · sign-like step
    lr = HP["lr"] * 2 / 4
    for name in ref_sae.LEAVES:
        gr = out["grads"][name]
        m, v = 0.1 * gr, 0.001 * gr * gr
        step = lr / (1 - 0.9 ** 3) * m / (torch.sqrt(v / (1 - 0.999 ** 3)) + 1e-8)
        torch.testing.assert_close(out["params"][name], p[name] - step)
    expect = torch.tensor([0 if f else min(int(c) + files * t, 2 ** 30)
                           for f, c in zip(fired, counters)])
    assert torch.equal(out["counters"].cpu(), expect)


def test_portbench_log_mel_against_a_dft_loop():
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(5000) * 0.1).astype(np.float32)
    got = ref_whisper.log_mel(audio, 80, "cpu").double()
    x = np.zeros(480000)
    x[:5000] = audio
    padded = np.pad(x, 200, mode="reflect")
    win = 0.5 * (1 - np.cos(2 * np.pi * np.arange(400) / 400))
    bank = ref_whisper.mel_bank(80).astype(np.float64)
    logs = []
    for frame in (0, 1, 17, 31):
        seg = padded[frame * 160: frame * 160 + 400] * win
        power = np.array([abs(sum(seg[m] * np.exp(-2j * np.pi * kk * m / 400)
                                  for m in range(400))) ** 2 for kk in range(201)])
        logs.append(np.log10(np.maximum(bank @ power, 1e-10)))
    # compare before the floor and scaling, which use the whole clip's max
    floor_max = (got.numpy() * 4 - 4).max()
    for frame, lg in zip((0, 1, 17, 31), logs):
        want = (np.maximum(lg, floor_max - 8) + 4) / 4
        np.testing.assert_allclose(got[:, frame].numpy(), want, rtol=2e-5, atol=2e-5)


def test_portbench_mel_bank_matches_librosa_shape_and_area():
    bank = ref_whisper.mel_bank(80)
    assert bank.shape == (80, 201) and np.count_nonzero(bank) == 391
    assert (bank >= 0).all() and np.isclose(bank.max(), 0.0263, atol=2e-3)


def test_portbench_encoder_block_against_loops():
    g = torch.Generator().manual_seed(1)
    d, heads, t = 4, 2, 3
    dims = {"n_audio_state": d, "n_audio_head": heads, "n_audio_ctx": t, "n_mels": 2}
    sd = {"encoder.conv1.weight": torch.randn(d, 2, 3, generator=g, dtype=F64),
          "encoder.conv1.bias": torch.randn(d, generator=g, dtype=F64),
          "encoder.conv2.weight": torch.randn(d, d, 3, generator=g, dtype=F64) * 0.3,
          "encoder.conv2.bias": torch.randn(d, generator=g, dtype=F64)}
    for name, shape in (("attn_ln.weight", (d,)), ("attn_ln.bias", (d,)),
                        ("attn.query.weight", (d, d)), ("attn.query.bias", (d,)),
                        ("attn.key.weight", (d, d)), ("attn.value.weight", (d, d)),
                        ("attn.value.bias", (d,)), ("attn.out.weight", (d, d)),
                        ("attn.out.bias", (d,)), ("mlp_ln.weight", (d,)), ("mlp_ln.bias", (d,)),
                        ("mlp.0.weight", (4 * d, d)), ("mlp.0.bias", (4 * d,)),
                        ("mlp.2.weight", (d, 4 * d)), ("mlp.2.bias", (d,))):
        sd[f"encoder.blocks.0.{name}"] = torch.randn(*shape, generator=g, dtype=F64) * 0.5
    sd["encoder.positional_embedding"] = ref_whisper.sinusoids(t, d).double()
    mels = torch.randn(1, 2, 2 * t, generator=g, dtype=F64)
    got = ref_whisper.encoder_to_block(sd, dims, mels, 0)[0]

    def conv(x, w, b, stride):  # x (c_in, L) with padding 1
        xp = F.pad(x, (1, 1))
        out_len = (x.shape[1] + 2 - 3) // stride + 1
        return torch.stack([torch.stack([b[o] + sum(w[o, c, j] * xp[c, i * stride + j]
                                                     for c in range(x.shape[0]) for j in range(3))
                                         for i in range(out_len)]) for o in range(w.shape[0])])

    x = F.gelu(conv(mels[0], sd["encoder.conv1.weight"], sd["encoder.conv1.bias"], 1))
    x = F.gelu(conv(x, sd["encoder.conv2.weight"], sd["encoder.conv2.bias"], 2)).T
    x = x + ref_whisper.sinusoids(t, d).double()
    w = lambda k: sd[f"encoder.blocks.0.{k}"]

    def ln(v, a, b):
        mu = v.mean()
        return (v - mu) / torch.sqrt(((v - mu) ** 2).mean() + 1e-5) * a + b

    h = torch.stack([ln(x[i], w("attn_ln.weight"), w("attn_ln.bias")) for i in range(t)])
    q = h @ w("attn.query.weight").T + w("attn.query.bias")
    k = h @ w("attn.key.weight").T
    v = h @ w("attn.value.weight").T + w("attn.value.bias")
    dh = d // heads
    att = torch.zeros(t, d, dtype=F64)
    for hd in range(heads):
        s = slice(hd * dh, (hd + 1) * dh)
        for i in range(t):
            scores = [float(q[i, s] @ k[j, s]) / math.sqrt(dh) for j in range(t)]
            e = [math.exp(sc - max(scores)) for sc in scores]
            att[i, s] = sum(e[j] / sum(e) * v[j, s] for j in range(t))
    x = x + att @ w("attn.out.weight").T + w("attn.out.bias")
    h = torch.stack([ln(x[i], w("mlp_ln.weight"), w("mlp_ln.bias")) for i in range(t)])
    x = x + F.gelu(h @ w("mlp.0.weight").T + w("mlp.0.bias")) @ w("mlp.2.weight").T \
        + w("mlp.2.bias")
    torch.testing.assert_close(got, x, rtol=1e-9, atol=1e-9)


def test_portbench_topk_gap_judges_answers():
    g = torch.Generator().manual_seed(0)
    acts = torch.relu(torch.randn(50, 40, generator=g))
    top = torch.topk(acts, 4, dim=-1)
    assert judge.topk_gap(top.values, top.indices, acts, 4) == 0.0
    idx = top.indices.clone()
    idx[7, 0] = torch.topk(acts[7], 40).indices[-1]  # a latent the row does not keep
    assert judge.topk_gap(top.values, idx, acts, 4) > 0.1
    vals = top.values.clone()
    vals[3, 2] += 0.5
    assert judge.topk_gap(vals, top.indices, acts, 4) > 0.1
    dup = top.indices.clone()
    dup[0, 1] = dup[0, 0]
    assert judge.topk_gap(top.values, dup, acts, 4) == math.inf


def test_portbench_top_features_errors_judge_answers():
    g = torch.Generator().manual_seed(1)
    acts = torch.relu(torch.randn(30, 50, generator=g))
    kth = torch.topk(acts, 5, dim=-1).values[:, -1:]
    dense = torch.where(acts >= kth, acts, torch.zeros_like(acts))
    idx = torch.sort(dense.amax(dim=0), descending=True, stable=True).indices[:8]
    traces = dense[:, idx].T

    def rms(i, t):
        return judge.answers_rms([judge.top_features_errors(i, t, acts, 5, 8)])

    assert rms(idx.tolist(), traces.tolist()) == 0.0
    worst = torch.sort(dense.amax(dim=0)).indices[0]
    bad = idx.clone()
    bad[0] = worst  # a feature far from the top eight
    assert rms(bad.tolist(), dense[:, bad].T.tolist()) > 0.01
    altered = traces.clone()
    altered[2, 4] += 1.0
    assert rms(idx.tolist(), altered.tolist()) > 0.01
    missed = traces.clone()
    missed[0, int(torch.argmax(traces[0]))] = 0.0  # a kept activation left at zero
    assert rms(idx.tolist(), missed.tolist()) > 0.01
    assert rms(idx.tolist()[:7], traces.tolist()) == math.inf


def test_portbench_leaf_norm_gap():
    ref = {"a": torch.ones(4), "b": torch.ones(2) * 1e-6}
    assert judge.leaf_norm_gap(ref, ref) == 0.0
    assert judge.leaf_norm_gap({"a": torch.zeros(4), "b": ref["b"]}, ref) == pytest.approx(1.0)
    assert judge.counted(ref) == ["a"]
