"""Inputs made from the run's seed: activation stores for training, WAV
corpora for collection and uploads, and SAE and Whisper weights.

Everything large is drawn on the run's device with one ``torch.Generator``
seeded from ``--seed`` (a few large calls), so the same seed gives the same
inputs on the same card and software. Files are written in the formats the
program reads: the activation store's ``.npy`` + metadata layout, 16-bit
WAV, the SAE checkpoint's and OpenAI's Whisper checkpoint's state dicts.
"""

from __future__ import annotations

import json
import math
import wave
from pathlib import Path

import numpy as np
import torch

SAMPLE_RATE = 16000


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


# ---------------------------------------------------------------- stores

class RowMaker:
    """Rows shaped like a Whisper residual stream: a shared mean (a few
    large dimensions, as Whisper's encoder has), a per-file offset, a
    shared low-rank part and heavy-tailed noise (a normal times a
    log-normal scale). A TopK SAE trained on such rows leaves latents dead,
    so its AuxK loss is live. ``block(i, j)`` → files [i, j) as a (j − i,
    frames, d) f32 device tensor; the draws for the shared parts are made
    once, the per-file ones block by block in file order."""

    def __init__(self, g, n_files, frames, d, p, device):
        self.g, self.n_files, self.frames, self.d, self.p = g, n_files, frames, d, p
        self.device = device
        kw = dict(generator=g, device=device)
        mean = torch.randn(d, **kw) * p["mean_scale"]
        n_big = max(1, int(d * p["outlier_share"]))
        big = torch.randperm(d, **kw)[:n_big]
        mean[big] *= p["outlier_gain"]
        self.mean = mean
        r = p["rank"]
        self.U = torch.randn(d, r, **kw) * (p["lowrank_scale"] / math.sqrt(r))
        self.offsets = torch.randn(n_files, d, **kw) * p["offset_scale"]

    def block(self, i: int, j: int) -> torch.Tensor:
        kw = dict(generator=self.g, device=self.device)
        n, t, d, p = j - i, self.frames, self.d, self.p
        z = torch.randn(n, t, self.U.shape[1], **kw)
        x = torch.randn(n, t, d, **kw)
        x *= torch.exp(p["tail"] * torch.randn(n, t, d, **kw))
        x *= p["noise_scale"]
        x += z @ self.U.T
        x += self.offsets[i:j, None, :]
        x += self.mean
        return x


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """(n, T, d) f32 → (n,) int64: Σ_t (t + 1) · Σ_c bits(x[t, c]), exact
    integer arithmetic on the f32 bit patterns, so two files with the same
    fingerprint hold the same rows in the same order (to the odds of a
    64-bit collision)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64).sum(dim=2)
    w = torch.arange(1, x.shape[1] + 1, dtype=torch.int64, device=x.device)
    return (bits * w).sum(dim=1)


def write_store(folder: Path, layer: str, maker: RowMaker, block_files: int = 16) -> np.ndarray:
    """A dense activation store of ``maker``'s files in the store's
    documented layout (``{layer}_tensors.npy``, one flattened file a row,
    and ``{layer}_metadata.json``); → each file's fingerprint."""
    folder.mkdir(parents=True, exist_ok=True)
    n, t, d = maker.n_files, maker.frames, maker.d
    out = np.lib.format.open_memmap(folder / f"{layer}_tensors.npy", mode="w+",
                                    dtype=np.float32, shape=(n, t * d))
    prints = []
    for i in range(0, n, block_files):
        j = min(i + block_files, n)
        x = maker.block(i, j)
        prints.append(fingerprint(x).cpu())
        out[i:j] = x.reshape(j - i, t * d).cpu().numpy()
        del x
    out.flush()
    del out
    meta = {"tensor_shape": [t, d], "activation_shape": [t, d],
            "filenames": [f"pb_{i:05d}.wav" for i in range(n)], "n_frames": [t] * n}
    with open(folder / f"{layer}_metadata.json", "w") as f:
        json.dump(meta, f)
    return torch.cat(prints).numpy()


def read_store_files(folder: Path, layer: str, files, frames: int, d: int) -> np.ndarray:
    """(len(files), frames, d) f32 rows of the store, read back from disk."""
    mm = np.load(folder / f"{layer}_tensors.npy", mmap_mode="r")
    return np.asarray(mm[np.asarray(files)]).reshape(len(files), frames, d)


# ---------------------------------------------------------------- weights

def topk_sae_weights(g: torch.Generator, d_in: int, n_dict: int, device) -> dict:
    """A TopK SAE as FREUD initialises one: encoder uniform ±1/√d_in, the
    decoder its row-normalised copy, zero biases; the checkpoint's
    state-dict names."""
    enc = (torch.rand(n_dict, d_in, generator=g, device=device) * 2 - 1) / math.sqrt(d_in)
    norm = torch.sqrt(torch.sum(enc * enc, dim=1, keepdim=True))
    return {"encoder.weight": enc,
            "encoder.bias": torch.zeros(n_dict, device=device),
            "W_dec": enc / (norm + torch.finfo(torch.float32).eps),
            "b_dec": torch.zeros(d_in, device=device)}


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def whisper_encoder_weights(g: torch.Generator, dims: dict, blocks: int, device) -> dict:
    """The encoder of a Whisper checkpoint (OpenAI's state-dict names) with
    ``blocks`` blocks: linears uniform ±1/√fan_in, convs N(0, 1/fan_in),
    unit LayerNorms, rounded to float16 as OpenAI's checkpoints are stored.
    The keys of the decoder are left out (collection never builds it)."""
    d, m = dims["n_audio_state"], dims["n_mels"]
    kw = dict(generator=g, device=device)
    sd = {}

    def linear(name, n_out, n_in, bias=True):
        b = 1.0 / math.sqrt(n_in)
        sd[f"{name}.weight"] = (torch.rand(n_out, n_in, **kw) * 2 - 1) * b
        if bias:
            sd[f"{name}.bias"] = (torch.rand(n_out, **kw) * 2 - 1) * b

    def ln(name):
        sd[f"{name}.weight"] = torch.ones(d, device=device)
        sd[f"{name}.bias"] = torch.zeros(d, device=device)

    sd["encoder.conv1.weight"] = torch.randn(d, m, 3, **kw) / math.sqrt(3 * m)
    sd["encoder.conv1.bias"] = torch.zeros(d, device=device)
    sd["encoder.conv2.weight"] = torch.randn(d, d, 3, **kw) / math.sqrt(3 * d)
    sd["encoder.conv2.bias"] = torch.zeros(d, device=device)
    sd["encoder.positional_embedding"] = torch.from_numpy(
        sinusoids(dims["n_audio_ctx"], d)).to(device)
    for i in range(blocks):
        p = f"encoder.blocks.{i}"
        ln(f"{p}.attn_ln")
        linear(f"{p}.attn.query", d, d)
        linear(f"{p}.attn.key", d, d, bias=False)
        linear(f"{p}.attn.value", d, d)
        linear(f"{p}.attn.out", d, d)
        ln(f"{p}.mlp_ln")
        linear(f"{p}.mlp.0", 4 * d, d)
        linear(f"{p}.mlp.2", d, 4 * d)
    ln("encoder.ln_post")
    return {k: v.to(torch.float16) for k, v in sd.items()}


# ---------------------------------------------------------------- audio

def wav_corpus(folder: Path, n_files: int, seconds: float, seed: int) -> list[Path]:
    """``n_files`` 16-kHz mono 16-bit WAVs of ``seconds`` each: per file a
    loudness, a few tones and noise, drawn from ``seed``."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = int(round(seconds * SAMPLE_RATE))
    t = np.arange(n, dtype=np.float32) / SAMPLE_RATE
    paths = []
    for i in range(n_files):
        amp = rng.uniform(0.02, 0.3)
        x = rng.standard_normal(n).astype(np.float32) * amp * 0.3
        for f0 in rng.uniform(80.0, 3000.0, 3):
            x += amp * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi)).astype(np.float32)
        pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
        path = folder / f"clip_{i:05d}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SAMPLE_RATE)
            w.writeframes(pcm.tobytes())
        paths.append(path)
    return paths


def read_wav(path: Path) -> np.ndarray:
    """A 16-bit mono WAV as f32 in [-1, 1)."""
    with wave.open(str(path), "rb") as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0


def write_whisper_checkpoint(folder: Path, model: str, dims: dict, sd: dict) -> Path:
    """``<folder>/<model>.pt`` in OpenAI's layout ({"dims", "model_state_dict"}),
    where the program finds a model by name (``FREUD_WHISPER_DIR``)."""
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / f"{model}.pt"
    torch.save({"dims": dict(dims), "model_state_dict": {k: v.cpu() for k, v in sd.items()}},
               path)
    return path


def write_sae_checkpoint(path: Path, sae: dict, sae_config: dict, d_in: int) -> Path:
    """A FREUD trainer checkpoint of a TopK SAE (``model``, ``hparams``)."""
    torch.save({"model": {k: v.cpu() for k, v in sae.items()},
                "hparams": {"autoencoder_variant": "topk",
                            "autoencoder_config": dict(sae_config),
                            "activation_size": int(d_in)}}, path)
    return path


def linked_corpus(folder: Path, clips: list, n_entries: int) -> None:
    """``n_entries`` names in ``folder``, each a symbolic link to one of
    ``clips`` in turn: a long corpus that cycles through the clips without
    a pass boundary in the loader."""
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(n_entries):
        (folder / f"item_{i:06d}.wav").symlink_to(clips[i % len(clips)])


def model_inputs(run, dev) -> dict:
    """The Whisper encoder (to the tap) and the TopK SAE of the run's
    configuration, from ``--seed``, written where the program reads them;
    → their float32 state dicts for the reference and the paths."""
    cfg = run.config
    wd = cfg["whisper"]
    sd = whisper_encoder_weights(generator(dev, run.seed_for("whisper")), wd,
                                 wd["n_audio_layer"], dev)
    wdir = write_whisper_checkpoint(run.tmp / "whisper", cfg["model"], wd, sd).parent
    d = wd["n_audio_state"]
    sae = topk_sae_weights(generator(dev, run.seed_for("sae")), d,
                           d * cfg["sae"]["expansion_factor"], dev)
    sae_path = write_sae_checkpoint(run.tmp / "sae.pth", sae, cfg["sae"], d)
    return {"whisper": {k: v.float().cpu() for k, v in sd.items()},
            "sae": {k: v.cpu() for k, v in sae.items()},
            "whisper_dir": wdir, "sae_path": sae_path}
