"""TopK sparse autoencoder with AuxK and multi-TopK losses (PyTorch).

The port of ``freud_tpu/models/sae/topk.py``: the same functions under the
same names, taking a ``TopKSAE`` module where JAX takes ``TopKParams``
(parameters ``encoder_weight`` (n_dict, d_in), ``encoder_bias``, ``W_dec``
(n_dict, d_in), ``b_dec``, the reference state-dict names). Losses are
normalised by the total variance Σ(x − mean₀(x))² over the file axis:

  fvu            = Σ(x̂ − x)² / tv
  auxk_loss      = auxk_alpha · min(num_dead/k_aux, 1) · Σ(ê − e)² / tv
                   (k_aux = d_in // 2, a decode of the dead latents)
  multi_topk_fvu = FVU of a 4k-sparse decode

``forward``/``forward_with_fired`` are the validation path: ``select_topk``
(a stable sort's order; on the card the indexed selection kernel,
``ops/topk_indexed``) and masked dense decodes.

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank holds a slice
of the batch's files. The total variance is a statistic of the WHOLE batch
(its mean over files and its sum), so it is reduced across the ranks before
it divides anything; each rank's terms are then its part of the global
loss (their sum over the ranks is the one-process loss), and ``fired`` is
ORed across the ranks. Kernels #4 and #3 run per rank on the rank's rows.
With one rank every value equals the one-process path's bit for bit. ``training_losses`` is the train step, routed
as JAX routes it (``topk.py:310-329``): multi_topk and n_dict ≥ 2¹⁵ take an
autograd formulation over kernel #3 (``ops/topk_threshold``); otherwise a
``torch.autograd.Function`` whose forward is kernel #4 (``ops/topk_fused``)
under bf16 matmuls or kernel #3 in f32, and whose backward is JAX's
hand-written VJP (``topk.py:409-470``): its five products as plain matrix
products (``W_dec``'s two as one of depth 2M, ``d1`` and ``d2`` as one), with
the masks and selects of the (M, n_dict) latent in two hand-written passes
around them (``ops/topk_backward``: the masked pair before the ``W_dec``
product, the routed cotangent and ``encoder_bias``'s column sum after it).

A dictionary split over a mesh's model axis (``model_mesh``, the trainer's
``shard_dict``; ``parallel/mesh.py``): each rank holds ``n_dict / P`` rows
of ``encoder_weight``, ``encoder_bias`` and ``W_dec`` and all of ``b_dec``,
and model peers hold the same batch rows. The same functions take the
``model_mesh``; its collectives are no-ops without one. The encode is
local (under bf16, kernel #4's encode launch); the thresholds are the whole
row's (``ops/topk_sharded``: kernel #3's selection across shards, routed
by the GLOBAL n_dict); each rank decodes its rows (kernel #4's decode
launch) and the partial decodes are summed over the model group before
the errors, so every model rank holds the whole loss. AuxK's scale reads
the global dead count. In the backward the dictionary's gradients stay
local and ``b_dec``'s encode-path term is summed over the model group.
The validation ``forward`` gives the top-k values with global indices
(ties to the lower index) and the summed reconstruction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ...ops.gemm_f32x3 import linear
from ...ops.topk_backward import topk_masked_pair, topk_route
from ...ops.topk_fused import topk_sae_decode, topk_sae_encode, topk_sae_forward
from ...ops.topk_indexed import topk_indexed, topk_indexed_plain
from ...ops.topk_sharded import sharded_thresholds_fired
from ...ops.topk_threshold import bisect_kth, topk_thresholds_fired
from ...parallel import mesh as mesh_lib
from ...parallel.mesh import all_reduce
from .config import TopKAutoEncoderConfig, get_n_dict_components


class TopKEncoderOutput(NamedTuple):
    top_acts: torch.Tensor  # (…, k)
    top_indices: torch.Tensor  # (…, k) int64


class TopKForwardOutput(NamedTuple):
    sae_out: torch.Tensor
    encoded: TopKEncoderOutput
    fvu: torch.Tensor
    auxk_loss: torch.Tensor
    multi_topk_fvu: torch.Tensor


class TopKSAE(nn.Module):
    """The TopK SAE's parameters (torch ``Linear`` layout for the encoder)."""

    def __init__(self, encoder_weight, encoder_bias, W_dec, b_dec):
        super().__init__()
        self.encoder_weight = nn.Parameter(torch.as_tensor(encoder_weight, dtype=torch.float32))
        self.encoder_bias = nn.Parameter(torch.as_tensor(encoder_bias, dtype=torch.float32))
        self.W_dec = nn.Parameter(torch.as_tensor(W_dec, dtype=torch.float32))
        self.b_dec = nn.Parameter(torch.as_tensor(b_dec, dtype=torch.float32))


TopKParams = TopKSAE  # the JAX package's name for the parameter set


def init_topk(activation_size: int, cfg: TopKAutoEncoderConfig, seed: int = 0,
              device: torch.device | str = "cpu") -> TopKSAE:
    """Uniform(±1/√d_in) encoder, W_dec its (row-normalised) copy, zero
    biases. The generator is torch's, so the numbers differ from JAX's for
    the same seed (``serialize.params_from_jax`` carries JAX's across)."""
    n_dict = get_n_dict_components(
        activation_size, cfg.expansion_factor, cfg.n_dict_components)
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / np.sqrt(activation_size)
    enc_w = (torch.rand((n_dict, activation_size), generator=gen) * 2 - 1) * bound
    W_dec = enc_w.clone()
    if cfg.normalize_decoder:
        W_dec = set_decoder_norm_to_unit_norm(W_dec)
    return TopKSAE(enc_w, torch.zeros(n_dict), W_dec,
                   torch.zeros(activation_size)).to(device)


def set_decoder_norm_to_unit_norm(W_dec: torch.Tensor) -> torch.Tensor:
    """Row-normalise W_dec (per dictionary component)."""
    norm = torch.sqrt(torch.sum(W_dec * W_dec, dim=1, keepdim=True))
    return W_dec / (norm + torch.finfo(W_dec.dtype).eps)


def remove_gradient_parallel_to_decoder_directions(
    W_dec: torch.Tensor, W_dec_grad: torch.Tensor
) -> torch.Tensor:
    """Project out the gradient component parallel to each decoder row."""
    parallel = torch.sum(W_dec_grad * W_dec, dim=1, keepdim=True)
    return W_dec_grad - parallel * W_dec


def _dot_f32(a: torch.Tensor, b: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """a @ b with operands rounded to ``matmul_dtype`` and f32 sums and
    result — JAX's ``dot(..., preferred_element_type=f32)``; differentiable."""
    if matmul_dtype is not None:
        a, b = a.to(matmul_dtype), b.to(matmul_dtype)
    return a.to(torch.float32) @ b.to(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, bf16: bool,
        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The backward's products (no autograd): bf16 operands when ``bf16``,
    f32 sums, ``out_dtype`` result. On the card a bf16 product with an f32
    result is one tensor-core GEMM; the CPU has no such op and sums the
    same bf16 products in f32."""
    if not bf16:
        return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if out_dtype == torch.bfloat16:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=out_dtype)
    return a.to(torch.float32) @ b.to(torch.float32)


def _encoder_product(params, x: torch.Tensor, matmul_dtype=None, b_dec=None) -> torch.Tensor:
    """(x − b_dec) · encoder_weightᵀ, operands in ``matmul_dtype``; CUDA f32
    outside autograd on the 3xTF32 kernel (``ops.gemm_f32x3``'s routing
    rule: collection, serving and search)."""
    sae_in = x - (params.b_dec if b_dec is None else b_dec)
    W = params.encoder_weight
    if matmul_dtype is not None:
        sae_in, W = sae_in.to(matmul_dtype), W.to(matmul_dtype)
    return linear(sae_in, W)


def pre_acts(params, x: torch.Tensor, matmul_dtype=None, b_dec=None) -> torch.Tensor:
    """relu((x − b_dec) · encoder_weightᵀ + encoder_bias); ``b_dec``
    overrides the parameter (the sharded step passes its model copy)."""
    z = _encoder_product(params, x, matmul_dtype, b_dec)
    return torch.relu(z + params.encoder_bias.to(z.dtype))


def select_topk(latents: torch.Tensor, k: int) -> TopKEncoderOutput:
    """The k largest per position, ties to the lower index (``lax.top_k``'s
    order; a stable descending sort keeps it): on the card the indexed
    selection kernel (``ops/topk_indexed``), on the CPU the sort itself
    (the kernel wrapper's checks, k ≤ 256 among them, do not apply there)."""
    select = topk_indexed if latents.is_cuda else topk_indexed_plain
    return TopKEncoderOutput(*select(latents, k))


def encode(params, x: torch.Tensor, cfg: TopKAutoEncoderConfig) -> TopKEncoderOutput:
    """``select_topk(pre_acts(params, x), k)``; on the card the selection
    kernel adds ``encoder_bias`` to the product and applies the ReLU in its
    load, bit for bit as ``pre_acts`` rounds them."""
    if not x.is_cuda:
        return select_topk(pre_acts(params, x), cfg.k)
    z = _encoder_product(params, x)
    return TopKEncoderOutput(*topk_indexed(z, cfg.k, bias=params.encoder_bias))


def dense_latent(top_acts: torch.Tensor, top_indices: torch.Tensor, n_dict: int) -> torch.Tensor:
    """Scatter an indexed activation back to a dense (…, n_dict) tensor."""
    dense = torch.zeros((*top_acts.shape[:-1], n_dict), dtype=top_acts.dtype,
                        device=top_acts.device)
    return dense.scatter_add(-1, top_indices.long(), top_acts)


def decode(params, top_acts: torch.Tensor, top_indices: torch.Tensor,
           matmul_dtype=None) -> torch.Tensor:
    """Sparse decode: gather k dictionary rows and weight them when
    k·d_in ≤ n_dict, else scatter to the dense latent and multiply."""
    n_dict, d_in = params.W_dec.shape
    k = top_acts.shape[-1]
    if k * d_in <= n_dict:
        rows = params.W_dec[top_indices.long()]  # (…, k, d_in)
        y = torch.einsum("...k,...kd->...d", top_acts, rows)
    else:
        y = _dot_f32(dense_latent(top_acts, top_indices, n_dict), params.W_dec,
                     matmul_dtype)
    return y + params.b_dec


def kth_threshold(acts: torch.Tensor, k: int, mask=None, iters: int = 24) -> torch.Tensor:
    """Per-position k-th-largest threshold by bisection: the largest t found
    with count(acts ≥ t) ≥ k (ties may admit extras); +inf when nothing is
    finite."""
    masked = acts if mask is None else torch.where(
        mask, acts, torch.tensor(float("-inf"), dtype=acts.dtype, device=acts.device))
    return bisect_kth(masked, k, iters)


def _masked_dense_decode(params, acts, threshold, matmul_dtype, select_mask=None,
                         model_mesh=None):
    """Decode the latents ≥ the per-position threshold as one product
    (gradients reach exactly the selected entries); a split dictionary's
    partial products summed over the model group."""
    keep = acts >= threshold
    if select_mask is not None:
        keep = keep & select_mask
    dense = torch.where(keep, acts, torch.zeros((), dtype=acts.dtype, device=acts.device))
    return mesh_lib.model_sum(model_mesh, _dot_f32(dense, params.W_dec, matmul_dtype)) \
        + params.b_dec


def _total_variance(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Σ(x − mean over the leading (file) axis)²; 1 where it is 0. With a
    ``mesh`` the file axis is every rank's files (equal slices): the mean
    and then the sum are reduced across the ranks."""
    if mesh is None:
        tv = torch.sum((x - x.mean(dim=0)) ** 2)
    else:
        # each rank's mean weighted by its share of the files; · 1 exactly
        # with one rank
        mu = all_reduce(mesh, x.mean(dim=0) * (1.0 / mesh.data_size))
        tv = all_reduce(mesh, torch.sum((x - mu) ** 2))
    return torch.where(tv == 0, torch.ones_like(tv), tv)


def _or_across(mesh, fired: torch.Tensor) -> torch.Tensor:
    """A fired mask ORed over the ranks (JAX's max of ``fired`` over the data
    axis)."""
    if mesh is None:
        return fired
    return all_reduce(mesh, fired.to(torch.int32), "max").bool()


def forward(params, x: torch.Tensor, cfg: TopKAutoEncoderConfig,
            dead_mask: Optional[torch.Tensor] = None, matmul_dtype=None,
            model_mesh=None) -> TopKForwardOutput:
    """``model_mesh``: the mesh whose model axis splits the dictionary
    (``params`` are this rank's rows; every model rank calls it)."""
    return _forward_impl(params, x, cfg, dead_mask, matmul_dtype, model_mesh)[0]


def forward_with_fired(params, x: torch.Tensor, cfg: TopKAutoEncoderConfig,
                       dead_mask: Optional[torch.Tensor] = None, matmul_dtype=None):
    """(forward output, fired) — ``fired[j]``: latent j was selected (with a
    positive value) anywhere in the batch."""
    return _forward_impl(params, x, cfg, dead_mask, matmul_dtype)


def _global_topk(acts: torch.Tensor, k: int, model_mesh) -> TopKEncoderOutput:
    """``select_topk`` of the whole row from this rank's columns ``acts``,
    with GLOBAL indices, ties to the lower index: each shard's own top-k
    (already in that order) gathered in model-rank order, then a stable
    descending sort, which keeps tied values in index order."""
    if not mesh_lib.model_sharded(model_mesh):
        return select_topk(acts, k)
    n_local = acts.shape[-1]
    local = select_topk(acts, min(k, n_local))
    lo = model_mesh.model_rank * n_local
    vals = mesh_lib.model_all_gather(model_mesh, local.top_acts.contiguous())
    idx = mesh_lib.model_all_gather(model_mesh, local.top_indices + lo)
    vals = torch.cat(list(vals.unbind(0)), dim=-1)
    idx = torch.cat(list(idx.unbind(0)), dim=-1)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices[..., :k]
    return TopKEncoderOutput(top_acts=torch.gather(vals, -1, order),
                             top_indices=torch.gather(idx, -1, order))


def _forward_impl(params, x, cfg, dead_mask, matmul_dtype, model_mesh=None):
    if dead_mask is not None and mesh_lib.model_sharded(model_mesh):
        raise ValueError("the validation forward of a split dictionary takes no dead mask")
    acts = pre_acts(params, x, matmul_dtype=matmul_dtype)
    top = _global_topk(acts, cfg.k, model_mesh)
    thresh = top.top_acts.amin(dim=-1, keepdim=True)
    keep = acts >= thresh
    # zero activations never fire: a silent frame's threshold is 0
    fired = (keep & (acts > 0)).reshape(-1, keep.shape[-1]).any(dim=0)
    sae_out = _masked_dense_decode(params, acts, thresh, matmul_dtype,
                                   model_mesh=model_mesh).to(x.dtype)
    e = sae_out - x
    tv = _total_variance(x)

    if dead_mask is not None:
        k_aux = x.shape[-1] // 2
        scale = torch.clamp(dead_mask.sum() / k_aux, max=1.0)
        dead = dead_mask.expand(acts.shape)
        aux_thresh = kth_threshold(acts, k_aux, mask=dead)
        e_hat = _masked_dense_decode(params, acts, aux_thresh, matmul_dtype,
                                     select_mask=dead)
        auxk_loss = scale * torch.sum((e_hat - e) ** 2) / tv
    else:
        auxk_loss = torch.zeros((), dtype=x.dtype, device=x.device)

    fvu = torch.sum(e * e) / tv

    if cfg.multi_topk:
        thresh4 = _global_topk(acts, 4 * cfg.k, model_mesh).top_acts.amin(dim=-1,
                                                                           keepdim=True)
        multi_out = _masked_dense_decode(params, acts, thresh4, matmul_dtype,
                                         model_mesh=model_mesh)
        multi_topk_fvu = torch.sum((multi_out - x) ** 2) / tv
    else:
        multi_topk_fvu = torch.zeros((), dtype=x.dtype, device=x.device)

    out = TopKForwardOutput(sae_out=sae_out, encoded=top, fvu=fvu,
                            auxk_loss=auxk_loss * cfg.auxk_alpha,
                            multi_topk_fvu=multi_topk_fvu)
    return out, fired


def training_losses(params, x: torch.Tensor, cfg: TopKAutoEncoderConfig,
                    dead_mask: torch.Tensor, matmul_dtype=None, mesh=None,
                    model_mesh=None, n_dead=None):
    """Loss terms and the fired mask for the TRAIN step:
    → ({fvu, auxk_loss, multi_topk_fvu}, fired). Differentiable in the
    parameters (and in x, unless the dictionary is split). With a ``mesh``, ``x`` is this rank's files: the
    terms are this rank's part of the global loss (normalised by the global
    total variance) and ``fired`` is the whole batch's. With a
    ``model_mesh`` whose model axis splits the dictionary, ``params`` and
    ``dead_mask`` are this rank's rows, ``fired`` is for those rows and
    ``n_dead``, the whole dictionary's dead count (a 0-dim f32 tensor), is
    required; without one it is ``dead_mask``'s own."""
    split = mesh_lib.model_sharded(model_mesh)
    if n_dead is None:
        if split:
            raise ValueError("a split dictionary's losses need the global n_dead")
        n_dead = dead_mask.sum().to(torch.float32)
    # the route reads the whole row's width, not a shard's
    n_dict = params.W_dec.shape[0] * (model_mesh.model_size if split else 1)
    tv = None if mesh is None else _total_variance(x.detach(), mesh)
    if cfg.multi_topk or n_dict >= 2 ** 15:
        terms, fired = _training_losses_xla(params, x, cfg, dead_mask, n_dead, matmul_dtype,
                                            tv, model_mesh)
        return terms, _or_across(mesh, fired)
    # JAX also sends recipes whose bf16 W_enc + W_dec exceed 64 MB to the
    # formulation above (KERNEL_RESIDENT_BUDGET, topk.py:41-46): that is the
    # TPU kernel's VMEM arena. The CUDA kernel keeps no weights resident, so
    # every size goes to it; the selection is the same exact bf16 selection.
    # The global total variance (a data-parallel step's) enters as an input:
    # the backward takes it as a constant of the parameters.
    fvu, auxk_loss, fired = _FusedLosses.apply(
        x, params.encoder_weight, params.encoder_bias, params.W_dec, params.b_dec,
        dead_mask.to(torch.float32), cfg.k, x.shape[-1] // 2, float(cfg.auxk_alpha),
        matmul_dtype == torch.bfloat16, tv, n_dead, model_mesh)
    return {
        "fvu": fvu,
        "auxk_loss": auxk_loss,
        "multi_topk_fvu": torch.zeros((), dtype=x.dtype, device=x.device),
    }, _or_across(mesh, fired)


def _thresholds(acts, dead, k, k_aux, model_mesh, k_multi=0):
    """Kernel #3's thresholds and fired mask of the (M, n) latent ``acts``;
    across the shards when the dictionary is split."""
    if mesh_lib.model_sharded(model_mesh):
        return sharded_thresholds_fired(acts, dead, k, k_aux, model_mesh, k_multi=k_multi)
    return topk_thresholds_fired(acts, dead, k, k_aux, k_multi=k_multi)


class _FusedLosses(torch.autograd.Function):
    """Forward: kernel #4 (bf16) or kernel #3 (f32, both decodes one
    product over ``topk_masked_pair``) plus the loss reductions. Backward: JAX's ``_fused_losses_bwd``, its products plain
    and its (M, n_dict) masks and selects in ``ops/topk_backward``'s two
    passes (one route for every dtype, a split dictionary's too).
    Thresholds are selection boundaries without gradient. ``tv``: the total
    variance that normalises the losses (a data-parallel step passes the
    global one); computed from ``x`` when None. ``n_dead``: the dead count.

    On a dictionary split over ``model_mesh`` the forward is kernel #4's
    encode launch (bf16) or the f32 product, the selection across shards,
    then kernel #4's decode launch (bf16) or the f32 products, the partial
    decodes summed over the model group; in the backward ``b_dec``'s
    encode-path term (a sum over every dictionary row) is summed over it
    too, so ``b_dec``'s gradient is the same on every model rank."""

    @staticmethod
    def forward(ctx, x, enc_w, enc_b, W_dec, b_dec, dead_f, k, k_aux, alpha, bf16,
                tv, n_dead, model_mesh):
        d_in = x.shape[-1]
        x2 = x.reshape(-1, d_in)
        split = mesh_lib.model_sharded(model_mesh)
        if bf16 and not split:
            acts, y_main, y_aux, t_main, t_aux, fired = topk_sae_forward(
                x2, enc_w.T, enc_b, b_dec, W_dec, dead_f, k, k_aux)
        else:
            if bf16:
                acts = topk_sae_encode(x2, enc_w.T, enc_b, b_dec)
            else:
                acts = torch.relu((x2 - b_dec) @ enc_w.T + enc_b)
            dead = dead_f > 0
            t_main, t_aux, _, fired = _thresholds(acts, dead, k, k_aux, model_mesh)
            if bf16:
                y = torch.stack(topk_sae_decode(acts, W_dec, dead_f, t_main, t_aux))
            else:  # both decodes one product over the backward's masked pair
                y = (topk_masked_pair(acts, t_main, t_aux, dead_f) @ W_dec).view(
                    2, acts.shape[0], -1)
            if split:  # ONE sum of both partial decodes
                y = mesh_lib.model_all_reduce(model_mesh, y)
            y_main, y_aux = y
        e = y_main + b_dec - x2  # = sae_out − x
        r = y_aux - y_main + x2  # = ê − e   (b_dec cancels)
        ctx.tv_given = tv is not None
        if tv is None:
            tv = _total_variance(x)
        scale = torch.clamp(n_dead / k_aux, max=1.0)
        fvu = torch.sum(e * e) / tv
        auxk_loss = alpha * scale * torch.sum(r * r) / tv
        ctx.save_for_backward(x, enc_w, W_dec, b_dec, acts, t_main, t_aux,
                              dead_f, e, r, tv, scale)
        ctx.consts = (alpha, bf16, model_mesh)
        ctx.mark_non_differentiable(fired)
        return fvu, auxk_loss, fired

    @staticmethod
    def backward(ctx, g_fvu, g_aux, _g_fired):
        x, enc_w, W_dec, b_dec, acts, t_main, t_aux, dead_f, e, r, tv, scale = (
            ctx.saved_tensors)
        alpha, bf16, model_mesh = ctx.consts
        x2 = x.reshape(-1, x.shape[-1])
        sae_in = x2 - b_dec
        c1 = 2.0 * g_fvu / tv
        c2 = 2.0 * g_aux * alpha * scale / tv
        # [∂L/∂y_main; ∂L/∂y_aux] (2M, d)
        g = torch.cat([c1 * e - c2 * r, c2 * r])
        g_main = g[:x2.shape[0]]

        # the (M, n_dict) passes are ops/topk_backward's, around the
        # products: [dense_main; dense_aux] makes dW_dec one product of
        # depth 2M
        dW_dec = _mm(topk_masked_pair(acts, t_main, t_aux, dead_f).T, g, bf16)
        db_dec = c1 * torch.sum(e, dim=0)  # Σ(∂L/∂y_main + ∂L/∂y_aux) = c1·Σe

        # only selected entries carry gradient; under bf16 the (M, n_dict)
        # cotangents stay bf16, as in JAX (topk.py:435); [d1; d2] is one
        # product
        ct = torch.bfloat16 if bf16 else torch.float32
        d_acts, db_enc = topk_route(_mm(g, W_dec.T, bf16, out_dtype=ct), acts, t_main,
                                    t_aux, dead_f)

        dW_enc = _mm(d_acts.T, sae_in, bf16)
        db_dec = db_dec - mesh_lib.model_all_reduce(
            model_mesh, _mm(db_enc[None, :], enc_w, bf16)[0])

        dx = dtv = None
        # ∂L/∂tv
        k_tv = -(c1 * torch.sum(e * e) + c2 * torch.sum(r * r)) / (2.0 * tv)
        if ctx.needs_input_grad[0]:
            # direct e/r terms, the encode path, and (tv computed here) the
            # total variance
            dx = (-g_main + _mm(d_acts, enc_w, bf16)).reshape(x.shape)
            if not ctx.tv_given:
                dx = dx + k_tv * 2.0 * (x - x.mean(dim=0))
        if ctx.tv_given and ctx.needs_input_grad[10]:
            dtv = k_tv
        return (dx, dW_enc, db_enc, dW_dec, db_dec, None, None, None, None, None, dtv,
                None, None)


def _training_losses_xla(params, x, cfg, dead_mask, n_dead, matmul_dtype=None, tv=None,
                         model_mesh=None):
    """Autograd formulation over kernel #3 (multi_topk; n_dict ≥ 2¹⁵):
    every threshold and the fired mask from one pass over the latent.
    ``tv``, ``n_dead``: as ``_FusedLosses``'. On a dictionary split over
    ``model_mesh`` the selection runs across the shards, the partial decodes
    are summed over the model group, and the encode reads ``b_dec`` through
    ``model_copy``."""
    acts = pre_acts(params, x, matmul_dtype=matmul_dtype,
                    b_dec=mesh_lib.model_copy(model_mesh, params.b_dec))
    n_local = acts.shape[-1]
    k_aux = x.shape[-1] // 2
    flat = acts.detach().reshape(-1, n_local)
    t_main, t_aux, t4, fired = _thresholds(
        flat, dead_mask, cfg.k, k_aux, model_mesh, k_multi=4 * cfg.k if cfg.multi_topk else 0)
    lead = acts.shape[:-1]
    t_main = t_main.reshape(*lead, 1).to(acts.dtype)
    t_aux = t_aux.reshape(*lead, 1).to(acts.dtype)

    sae_out = _masked_dense_decode(params, acts, t_main, matmul_dtype,
                                   model_mesh=model_mesh).to(x.dtype)
    e = sae_out - x
    if tv is None:
        tv = _total_variance(x)
    fvu = torch.sum(e * e) / tv

    scale = torch.clamp(n_dead / k_aux, max=1.0)
    dead = dead_mask.expand(acts.shape)
    e_hat = _masked_dense_decode(params, acts, t_aux, matmul_dtype, select_mask=dead,
                                 model_mesh=model_mesh)
    auxk_loss = cfg.auxk_alpha * scale * torch.sum((e_hat - e) ** 2) / tv

    if cfg.multi_topk:
        thresh4 = t4.reshape(*lead, 1).to(acts.dtype)
        multi_out = _masked_dense_decode(params, acts, thresh4, matmul_dtype,
                                         model_mesh=model_mesh)
        multi_topk_fvu = torch.sum((multi_out - x) ** 2) / tv
    else:
        multi_topk_fvu = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"fvu": fvu, "auxk_loss": auxk_loss, "multi_topk_fvu": multi_topk_fvu}, fired


def age_counters(num_frames_since_fired: torch.Tensor, fired: torch.Tensor,
                 frames_in_batch) -> torch.Tensor:
    """Dead-feature bookkeeping from a fired mask: every latent ages by the
    batch's frame count (saturating at 2³⁰); fired ones reset."""
    aged = torch.clamp(num_frames_since_fired + frames_in_batch, max=2 ** 30)
    return torch.where(fired, torch.zeros_like(aged), aged)


def update_fired_counters(num_frames_since_fired: torch.Tensor,
                          top_indices: torch.Tensor, frames_in_batch) -> torch.Tensor:
    """Dead-feature bookkeeping from selected indices (reference
    train_sae.py:412-446)."""
    did_fire = torch.zeros_like(num_frames_since_fired, dtype=torch.bool)
    did_fire[top_indices.reshape(-1).long()] = True
    return age_counters(num_frames_since_fired, did_fire, frames_in_batch)


def param_count(params) -> int:
    return int(sum(p.numel() for p in params.parameters()))
