"""L1-regularised tied-weight sparse autoencoder (PyTorch).

The port of ``freud_tpu/models/sae/l1.py``: one matrix W (activation_size,
n_dict) whose transpose is the encoder, and an encoder bias. Decoder columns
are renormalised to unit norm before use (``normalize_columns``; the trainer
applies it to the parameter in place at the start of every step). Loss =
recon_alpha · masked-MSE(x̂, x; ignore −1) + mean per-frame L1 of the latent.

Under ``matmul_dtype=torch.bfloat16`` both products take and return bf16,
as JAX's default-precision matmuls do (``l1.py:81-90``); the losses reduce
in f32. L1 has no kernel: the fused L1 kernel was removed from the JAX
package because XLA beat it (COMPONENTS.md).

With a ``mesh`` (data parallelism, each rank a slice of the files) both
normalisers are the whole batch's: the masked MSE divides by Σmask summed
over the ranks, and the L1 mean is over every rank's frames. Each rank's
losses are then its part of the global loss.

With a dictionary split over a mesh's model axis (``model_mesh``, the
trainer's ``shard_dict``) each rank holds ``n_dict / P`` columns of W and
their biases: the latents are local, x̂ is the sum over the model group of
each rank's partial product (bf16 operands, f32 sums and result, rounded
to the matmul dtype after the sum), and so is the L1 term;
``normalize_columns`` acts per column and stays local.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ...parallel import mesh as mesh_lib
from ...parallel.mesh import all_reduce
from .config import L1AutoEncoderConfig, get_n_dict_components
from .topk import _mm


class L1EncoderOutput(NamedTuple):
    latent: torch.Tensor


class L1ForwardOutput(NamedTuple):
    sae_out: torch.Tensor
    encoded: L1EncoderOutput
    l1_loss: torch.Tensor
    reconstruction_loss: torch.Tensor


class L1Weights(NamedTuple):
    """A (W, encoder_bias) pair — what ``normalize_columns`` returns."""
    W: torch.Tensor
    encoder_bias: torch.Tensor


class L1SAE(nn.Module):
    """The L1 SAE's parameters; W is the torch ``decoder.weight`` layout."""

    def __init__(self, W, encoder_bias):
        super().__init__()
        self.W = nn.Parameter(torch.as_tensor(W, dtype=torch.float32))
        self.encoder_bias = nn.Parameter(torch.as_tensor(encoder_bias, dtype=torch.float32))


L1Params = L1SAE  # the JAX package's name for the parameter set


def init_l1(activation_size: int, cfg: L1AutoEncoderConfig, seed: int = 0,
            device: torch.device | str = "cpu") -> L1SAE:
    """Orthogonal init of W (QR of a normal matrix), zero bias; torch's
    generator, so not JAX's numbers for the same seed."""
    n_dict = get_n_dict_components(
        activation_size, cfg.expansion_factor, cfg.n_dict_components)
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((max(activation_size, n_dict), min(activation_size, n_dict)),
                    generator=gen)
    q, _ = torch.linalg.qr(a)
    W = q[:activation_size, :n_dict] if activation_size >= n_dict else q[:n_dict, :activation_size].T
    return L1SAE(W.contiguous(), torch.zeros(n_dict)).to(device)


def normalize_columns(params) -> L1Weights:
    """Unit-norm decoder columns (dim 0), the per-encode projection."""
    norm = torch.sqrt(torch.sum(params.W * params.W, dim=0, keepdim=True))
    return L1Weights(W=params.W / torch.clamp(norm, min=1e-12),
                     encoder_bias=params.encoder_bias)


def encode(params, x: torch.Tensor, *, pre_normalized: bool = False,
           matmul_dtype=None) -> L1EncoderOutput:
    """ReLU(x @ W + b) on unit-norm columns → latent (…, n_dict)."""
    if not pre_normalized:
        params = normalize_columns(params)
    W, b = params.W, params.encoder_bias
    if matmul_dtype is not None:
        x, W = x.to(matmul_dtype), W.to(matmul_dtype)
    return L1EncoderOutput(latent=torch.relu(x @ W + b.to(x.dtype)))


def decode(params, latent: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    W = params.W
    if matmul_dtype is not None:
        W, latent = W.to(matmul_dtype), latent.to(matmul_dtype)
    return latent @ W.T


class _PartialDecode(torch.autograd.Function):
    """A split dictionary's partial decode c · Wᵀ for bf16 latents: bf16
    operands, f32 sums and an f32 result (rounded to bf16 only after the sum
    over the model group), one tensor-core GEMM on the card (``topk._mm``);
    the backward's products are bf16 ones, as the unsplit decode's."""

    @staticmethod
    def forward(ctx, c, W):
        ctx.save_for_backward(c, W)
        return _mm(c.reshape(-1, c.shape[-1]), W.T, True).reshape(*c.shape[:-1], W.shape[0])

    @staticmethod
    def backward(ctx, g):
        c, W = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dc = _mm(g2, W, True, out_dtype=torch.bfloat16).reshape(c.shape).to(c.dtype)
        dW = _mm(g2.T, c.reshape(-1, c.shape[-1]), True, out_dtype=torch.bfloat16)
        return dc, dW.to(W.dtype)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, ignored_value: float = -1.0,
               mesh=None):
    """MSE over elements where target != ignored_value (reference mse_loss);
    with a ``mesh``, this rank's part of the MSE over every rank's
    elements."""
    mask = target != ignored_value
    se = torch.where(mask, (pred - target) ** 2, torch.zeros((), dtype=pred.dtype,
                                                             device=pred.device))
    return torch.sum(se) / torch.clamp(all_reduce(mesh, torch.sum(mask)), min=1)


def forward(params, x: torch.Tensor, cfg: L1AutoEncoderConfig, *,
            pre_normalized: bool = False, matmul_dtype=None, mesh=None,
            model_mesh=None) -> L1ForwardOutput:
    """``mesh``: the data axis' normalisers; ``model_mesh``: the mesh whose
    model axis splits the dictionary (``params`` are this rank's columns;
    the latent returned is this rank's)."""
    if not pre_normalized:
        params = normalize_columns(params)
    c = encode(params, x, pre_normalized=True, matmul_dtype=matmul_dtype).latent
    # losses in f32 (matmuls reduced, reductions full)
    l1 = torch.mean(torch.sum(torch.abs(c.to(torch.float32)), dim=-1))
    if mesh_lib.model_sharded(model_mesh):
        part = (_PartialDecode.apply(c, params.W) if c.dtype == torch.bfloat16
                else c @ params.W.T)
        x_hat = mesh_lib.model_sum(model_mesh, part).to(c.dtype).to(x.dtype)
        l1 = mesh_lib.model_sum(model_mesh, l1)
    else:
        x_hat = decode(params, c, matmul_dtype=matmul_dtype).to(x.dtype)
    if mesh is not None:
        # this rank's share of the mean over every rank's frames (equal
        # slices; · 1 exactly with one rank)
        l1 = l1 * (1.0 / mesh.data_size)
    recon = cfg.recon_alpha * masked_mse(x_hat, x, mesh=mesh)
    return L1ForwardOutput(sae_out=x_hat, encoded=L1EncoderOutput(c), l1_loss=l1,
                           reconstruction_loss=recon)


def param_count(params) -> int:
    return int(sum(p.numel() for p in params.parameters()))
