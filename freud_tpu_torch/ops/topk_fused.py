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

``topk_sae_forward`` dispatches on the device: a CUDA tensor launches the
kernel, a CPU tensor takes ``topk_sae_forward_plain``.
``topk_sae_forward.launches`` counts kernel launches; a launch captured into a
CUDA graph counts in ``.captured``, and each replay adds it to ``.launches``
(``train/graph.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .._native import check_cuda_status, cuda_library
from .topk_threshold import fired_from_bits, topk_thresholds_fired_plain


def topk_sae_forward_plain(x2, enc_w_t, enc_b, b_dec, W_dec, dead_f,
                           k: int, k_aux: int):
    """Plain PyTorch version: f32 products of bf16-rounded operands rounded
    to bf16 (the kernel's bf16 products with f32 sums), then the plain
    selection and dense masked decodes."""
    bf16, f32 = torch.bfloat16, torch.float32
    sae_in = (x2 - b_dec).to(bf16)
    z = sae_in.to(f32) @ enc_w_t.to(bf16).to(f32)
    acts = torch.relu(z.to(bf16) + enc_b.to(bf16))
    dead = dead_f > 0
    t_main, t_aux, _, fired = topk_thresholds_fired_plain(acts, dead, k, k_aux)
    af = acts.to(f32)
    zero = torch.zeros((), dtype=f32, device=af.device)
    w = W_dec.to(bf16).to(f32)
    y_main = torch.where(af >= t_main, af, zero) @ w
    y_aux = torch.where((af >= t_aux) & dead, af, zero) @ w
    return acts, y_main, y_aux, t_main, t_aux, fired


def _library() -> ctypes.CDLL:
    lib = cuda_library("topk_fused")
    lib.freud_topk_fused_max_n.restype = ctypes.c_int
    lib.freud_topk_fused_max_n.argtypes = []
    lib.freud_topk_sae_forward.restype = ctypes.c_int
    lib.freud_topk_sae_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.freud_cuda_error_string.restype = ctypes.c_char_p
    lib.freud_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


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
    if x2.ndim != 2 or x2.dtype != torch.float32:
        raise ValueError(f"x2 must be (M, d_in) float32, got {tuple(x2.shape)} {x2.dtype}")
    m, d = x2.shape
    n = enc_w_t.shape[1]
    if enc_w_t.shape != (d, n) or W_dec.shape != (n, d):
        raise ValueError(f"enc_w_t {tuple(enc_w_t.shape)} / W_dec "
                         f"{tuple(W_dec.shape)} do not match d_in {d}")
    if enc_b.shape != (n,) or b_dec.shape != (d,) or dead_f.shape != (n,):
        raise ValueError("enc_b, b_dec, dead_f must be (n_dict,), (d_in,), (n_dict,)")
    if d % 32 or n % 8:
        raise ValueError(f"the kernel needs d_in % 32 == 0 and n_dict % 8 == 0: "
                         f"d_in {d}, n_dict {n}")
    if min(k, k_aux) < 1:
        raise ValueError(f"k {k}, k_aux {k_aux} must be >= 1")
    for t in (enc_w_t, enc_b, b_dec, W_dec, dead_f):
        if t.device != x2.device:
            raise ValueError(f"operands must be on {x2.device}, got {t.device}")
    lib = _library()
    max_n = lib.freud_topk_fused_max_n()
    if n > max_n:
        raise ValueError(f"n_dict {n} is wider than the selection's rows ({max_n})")
    # operand preparation: the (n_dict, d_in) layout is the encoder weight's
    # own (Linear), so the transpose back is free before the bf16 cast
    x2 = x2.contiguous()
    if x2.data_ptr() % 16:  # the centring pass reads x with 16-byte loads
        x2 = x2.clone()
    w_enc = enc_w_t.t().to(torch.bfloat16).contiguous()
    b_enc = enc_b.to(torch.bfloat16).contiguous()
    w_dec = W_dec.to(torch.bfloat16).contiguous()
    b_dec32 = b_dec.to(torch.float32).contiguous()
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.freud_topk_sae_forward(
            x2.data_ptr(), b_dec32.data_ptr(), w_enc.data_ptr(), b_enc.data_ptr(),
            w_dec.data_ptr(), dead.data_ptr(), m, n, d, k, k_aux, acts.data_ptr(),
            y_main.data_ptr(), y_aux.data_ptr(), t_main.data_ptr(),
            t_aux.data_ptr(), fired.data_ptr(), xs.data_ptr(), dead_bits.data_ptr(),
            stream)
    check_cuda_status(status, "topk SAE forward kernel", lib)
    if torch.cuda.is_current_stream_capturing():
        topk_sae_forward.captured += 1  # launched by each replay (train/graph.py)
    else:
        topk_sae_forward.launches += 1
    return acts, y_main, y_aux, t_main, t_aux, fired_from_bits(fired, n)


topk_sae_forward.launches = 0
topk_sae_forward.captured = 0
