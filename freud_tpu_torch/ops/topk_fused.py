"""Fused TopK-SAE training forward, as a hand-written CUDA kernel
(``csrc/topk_fused.cu``).

Replaces the Pallas TPU kernel ``freud_tpu/ops/topk_fused.py``
(``topk_sae_forward`` → ``_forward_impl``). For x (M, d_in):

  acts   = relu(bf16(bf16(x − b_dec) · W_encᵀ) + bf16(b_enc))   (M, n_dict) bf16
  t_main, t_aux = exact per-row k-th / k_aux-th-among-dead thresholds
  y_main, y_aux = the two masked decodes · W_dec (f32, b_dec excluded)
  fired  = latents with acts ≥ t_main and acts > 0 in any row

The selection rules are ``ops/topk_threshold``'s exact path. On the card the
forward is five launches (the design is in the source's header): x − b_dec
rounded to bf16, the dead mask packed to bits, the encode GEMM (wgmma fed by
TMA), the selection core shared with kernel #3 (``csrc/topk_select.cuh``:
a radix select per row over the keys that can hold the k-th, rows streamed
by a persistent grid), and both masked decodes as one dense GEMM
whose acts operand is masked in registers. The signature is JAX's:
``enc_w_t`` is the encoder weight transposed, (d_in, n_dict).

On a dictionary split over a mesh's model axis a row's thresholds are the
whole row's, which no rank holds: ``topk_sae_encode`` (the centring and the
encode GEMM) and ``topk_sae_decode`` (the dead bits and both masked decodes
under given thresholds) are the forward's launches on either side of the
selection across shards (``ops/topk_sharded``), and each rank decodes its
own dictionary rows.

Each wrapper dispatches on the device: a CUDA tensor launches the kernel, a
CPU tensor takes its ``*_plain`` version. ``.launches`` counts a wrapper's
kernel launches; a launch captured into a CUDA graph counts in
``.captured``, and each replay adds it to ``.launches`` (``_native.counted``,
``train/graph.py``).
"""

from __future__ import annotations

import torch

from .._native import Kernel, counted, limit
from .topk_threshold import fired_from_bits, topk_thresholds_fired_plain


def topk_sae_encode_plain(x2, enc_w_t, enc_b, b_dec):
    """Plain PyTorch version of the encode: f32 products of bf16-rounded
    operands rounded to bf16 (the kernel's bf16 products with f32 sums)."""
    bf16, f32 = torch.bfloat16, torch.float32
    sae_in = (x2 - b_dec).to(bf16)
    z = sae_in.to(f32) @ enc_w_t.to(bf16).to(f32)
    return torch.relu(z.to(bf16) + enc_b.to(bf16))


def topk_sae_decode_plain(acts, W_dec, dead_f, t_main, t_aux):
    """Plain PyTorch version of the decodes: dense masked products."""
    f32 = torch.float32
    af = acts.to(f32)
    zero = torch.zeros((), dtype=f32, device=af.device)
    w = W_dec.to(torch.bfloat16).to(f32)
    y_main = torch.where(af >= t_main, af, zero) @ w
    y_aux = torch.where((af >= t_aux) & (dead_f > 0), af, zero) @ w
    return y_main, y_aux


def topk_sae_forward_plain(x2, enc_w_t, enc_b, b_dec, W_dec, dead_f,
                           k: int, k_aux: int):
    """Plain PyTorch version: the plain encode, selection and decodes."""
    acts = topk_sae_encode_plain(x2, enc_w_t, enc_b, b_dec)
    t_main, t_aux, _, fired = topk_thresholds_fired_plain(acts, dead_f > 0, k, k_aux)
    y_main, y_aux = topk_sae_decode_plain(acts, W_dec, dead_f, t_main, t_aux)
    return acts, y_main, y_aux, t_main, t_aux, fired


_FORWARD = Kernel("topk_fused", "freud_topk_sae_forward", "topk SAE forward kernel")
_ENCODE = Kernel("topk_fused", "freud_topk_sae_encode", "topk SAE encode kernel")
_DECODE = Kernel("topk_fused", "freud_topk_sae_decode", "topk SAE decode kernel")


def _check(m_like: torch.Tensor, d: int, n: int, *operands) -> None:
    """The kernel's shape rules and one device for every operand."""
    if d % 32 or n % 8:
        raise ValueError(f"the kernel needs d_in % 32 == 0 and n_dict % 8 == 0: "
                         f"d_in {d}, n_dict {n}")
    for t in operands:
        if t.device != m_like.device:
            raise ValueError(f"operands must be on {m_like.device}, got {t.device}")


def _encode_operands(x2, enc_w_t, enc_b, b_dec):
    """The checked encode operands as the kernel reads them: → (m, d, n, x2
    f32, w_enc (n, d) bf16, b_enc bf16, b_dec f32)."""
    if x2.ndim != 2 or x2.dtype != torch.float32:
        raise ValueError(f"x2 must be (M, d_in) float32, got {tuple(x2.shape)} {x2.dtype}")
    m, d = x2.shape
    n = enc_w_t.shape[1]
    if enc_w_t.shape != (d, n) or enc_b.shape != (n,) or b_dec.shape != (d,):
        raise ValueError(f"enc_w_t {tuple(enc_w_t.shape)}, enc_b {tuple(enc_b.shape)}, "
                         f"b_dec {tuple(b_dec.shape)} do not match d_in {d}")
    _check(x2, d, n, enc_w_t, enc_b, b_dec)
    # the (n_dict, d_in) layout is the encoder weight's own (Linear), so the
    # transpose back is free before the bf16 cast
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # the centring pass reads x with 16-byte loads
        x2 = x2.clone()
    return (m, d, n, x2, enc_w_t.t().to(torch.bfloat16).contiguous(),
            enc_b.to(torch.bfloat16).contiguous(), b_dec.to(torch.float32).contiguous())


@counted(_FORWARD)
def topk_sae_forward(
    x2: torch.Tensor,       # (M, d_in) f32
    enc_w_t: torch.Tensor,  # (d_in, n_dict) — encoder weight, transposed
    enc_b: torch.Tensor,    # (n_dict,) — used as bf16
    b_dec: torch.Tensor,    # (d_in,) f32
    W_dec: torch.Tensor,    # (n_dict, d_in) — used as bf16
    dead_f: torch.Tensor,   # (n_dict,) f32, > 0 = dead
    k: int,
    k_aux: int,
):
    """→ (acts (M, n_dict) bf16, y_main (M, d_in) f32, y_aux, t_main (M, 1)
    f32, t_aux (M, 1) f32, fired (n_dict,) bool). y_* exclude b_dec."""
    if not x2.is_cuda:
        return topk_sae_forward_plain(x2, enc_w_t, enc_b, b_dec, W_dec, dead_f, k, k_aux)
    m, d, n, x2, w_enc, b_enc, b_dec32 = _encode_operands(x2, enc_w_t, enc_b, b_dec)
    if W_dec.shape != (n, d) or dead_f.shape != (n,):
        raise ValueError(f"W_dec {tuple(W_dec.shape)}, dead_f {tuple(dead_f.shape)} do not "
                         f"match n_dict {n}, d_in {d}")
    _check(x2, d, n, W_dec, dead_f)
    if min(k, k_aux) < 1:
        raise ValueError(f"k {k}, k_aux {k_aux} must be >= 1")
    max_n = limit("topk_fused", "freud_topk_fused_max_n")
    if n > max_n:
        raise ValueError(f"n_dict {n} is wider than the selection's rows ({max_n})")
    w_dec = W_dec.to(torch.bfloat16).contiguous()
    dead = (dead_f > 0).to(torch.uint8)
    dev = x2.device
    acts = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    y_main = torch.empty((m, d), dtype=torch.float32, device=dev)
    y_aux = torch.empty_like(y_main)
    t_main = torch.empty((m, 1), dtype=torch.float32, device=dev)
    t_aux = torch.empty_like(t_main)
    fired = torch.zeros((-(-n // 32),), dtype=torch.int32, device=dev)  # bits
    # scratch: bf16(x − b_dec), the operand TMA feeds the encode; the dead
    # mask as bits, padded to whole 64-column slices of the decode
    xs = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    dead_bits = torch.zeros((2 * -(-n // 64),), dtype=torch.int32, device=dev)
    _FORWARD(x2, b_dec32, w_enc, b_enc, w_dec, dead, m, n, d, k, k_aux, acts, y_main, y_aux,
             t_main, t_aux, fired, xs, dead_bits)
    return acts, y_main, y_aux, t_main, t_aux, fired_from_bits(fired, n)


@counted(_ENCODE)
def topk_sae_encode(x2: torch.Tensor, enc_w_t: torch.Tensor, enc_b: torch.Tensor,
                    b_dec: torch.Tensor) -> torch.Tensor:
    """The forward's encode (operands as ``topk_sae_forward``'s): → acts
    (M, n_dict) bf16."""
    if not x2.is_cuda:
        return topk_sae_encode_plain(x2, enc_w_t, enc_b, b_dec)
    m, d, n, x2, w_enc, b_enc, b_dec32 = _encode_operands(x2, enc_w_t, enc_b, b_dec)
    acts = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    xs = torch.empty((m, d), dtype=torch.bfloat16, device=x2.device)  # bf16(x − b_dec)
    _ENCODE(x2, b_dec32, w_enc, b_enc, m, n, d, acts, xs)
    return acts


@counted(_DECODE)
def topk_sae_decode(acts: torch.Tensor, W_dec: torch.Tensor, dead_f: torch.Tensor,
                    t_main: torch.Tensor, t_aux: torch.Tensor):
    """The forward's masked decodes of acts (M, n_dict) bf16 under the
    thresholds t_main, t_aux (M, 1) f32, each a bf16 value (the exact path's,
    +inf for none): → (y_main, y_aux) (M, d_in) f32, b_dec excluded."""
    if not acts.is_cuda:
        return topk_sae_decode_plain(acts, W_dec, dead_f, t_main, t_aux)
    if acts.ndim != 2 or acts.dtype != torch.bfloat16:
        raise ValueError(f"acts must be (M, n_dict) bfloat16, got {tuple(acts.shape)} "
                         f"{acts.dtype}")
    m, n = acts.shape
    d = W_dec.shape[1]
    if W_dec.shape != (n, d) or dead_f.shape != (n,) or t_main.shape != (m, 1) \
            or t_aux.shape != (m, 1):
        raise ValueError(f"W_dec {tuple(W_dec.shape)}, dead_f {tuple(dead_f.shape)}, "
                         f"t_main {tuple(t_main.shape)}, t_aux {tuple(t_aux.shape)} do not "
                         f"match acts {(m, n)}")
    _check(acts, d, n, W_dec, dead_f, t_main, t_aux)
    dev = acts.device
    acts = acts.contiguous()
    w_dec = W_dec.to(torch.bfloat16).contiguous()
    dead = (dead_f > 0).to(torch.uint8)
    t_main = t_main.to(torch.float32).contiguous()
    t_aux = t_aux.to(torch.float32).contiguous()
    y_main = torch.empty((m, d), dtype=torch.float32, device=dev)
    y_aux = torch.empty_like(y_main)
    dead_bits = torch.zeros((2 * -(-n // 64),), dtype=torch.int32, device=dev)  # scratch
    _DECODE(acts, w_dec, dead, t_main, t_aux, m, n, d, y_main, y_aux, dead_bits)
    return y_main, y_aux
