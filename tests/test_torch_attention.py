"""freud_tpu_torch fused q/k/v attention against freud_tpu's Pallas kernel
(interpret mode) and numpy. The CUDA kernel is held against the plain
version on a card in tests/test_torch_cuda.py.

Tolerances: the JAX kernel runs bf16 products (f32 accumulate), so the f32
plain port meets it within max |Δ| / max |ref| < 2e-2 (the bound of
tests/test_attention_kernel.py); the plain port against f32 numpy math is
held to 1e-5 absolute (f32 rounding over a 40-key softmax). With
``matmul_dtype=torch.bfloat16`` the plain port rounds x, the weights, q/k/v
and the probabilities where the JAX kernel does, so the two differ only by
the order of f32 sums: max |Δ| / max |ref| < 1e-5 (measured ≤ 1.9e-7 for
f32 x, 0 for bf16 x, whose output is rounded to bf16 on both sides)."""

import numpy as np
import pytest
import torch

from freud_tpu.ops.attention import fused_qkv_attention as jax_fused
from freud_tpu_torch.ops.attention import (
    fused_qkv_attention,
    fused_qkv_attention_plain,
)


def _inputs(b, s, d, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32) * 0.5
    wq, wk, wv = (rng.standard_normal((d, d)).astype(np.float32) * 0.2
                  for _ in range(3))
    bq, bv = (rng.standard_normal((d,)).astype(np.float32) * 0.1 for _ in range(2))
    return x, wq, bq, wk, wv, bv


def _numpy_reference(x, wq, bq, wk, wv, bv, h):
    b, s, d = x.shape
    dh = d // h
    q = x @ wq + bq
    k = x @ wk
    v = x @ wv + bv
    qh = q.reshape(b, s, h, dh).transpose(0, 2, 1, 3) * dh ** -0.5
    kh = k.reshape(b, s, h, dh).transpose(0, 2, 1, 3)
    vh = v.reshape(b, s, h, dh).transpose(0, 2, 1, 3)
    sc = np.einsum("bhsd,bhtd->bhst", qh, kh)
    sc = sc - sc.max(-1, keepdims=True)
    p = np.exp(sc)
    ref = np.einsum("bhst,bhtd->bhsd", p / p.sum(-1, keepdims=True), vh)
    return ref.transpose(0, 2, 1, 3).reshape(b, s, d)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(x_dtype):
    args = _inputs(2, 40, 32)
    h = 4
    import jax.numpy as jnp

    jx = jnp.asarray(args[0]).astype(x_dtype)
    want = np.asarray(jax_fused(jx, *args[1:], h, interpret=True), np.float32)
    tx = torch.from_numpy(args[0]).to(getattr(torch, x_dtype))
    got = fused_qkv_attention(tx, *(torch.from_numpy(a) for a in args[1:]), h)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.to(torch.float32).numpy()
    assert np.max(np.abs(got - want)) / np.abs(want).max() < 2e-2


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_bf16_plain_matches_jax_kernel(x_dtype):
    """The bf16-rounded plain version is the kernels' contract: it meets
    the JAX kernel (interpret mode) to f32 summation order."""
    args = _inputs(2, 40, 32, seed=7)
    h = 4
    import jax.numpy as jnp

    jx = jnp.asarray(args[0]).astype(x_dtype)
    want = np.asarray(jax_fused(jx, *args[1:], h, interpret=True), np.float32)
    tx = torch.from_numpy(args[0]).to(getattr(torch, x_dtype))
    got = fused_qkv_attention_plain(tx, *(torch.from_numpy(a) for a in args[1:]), h,
                                    matmul_dtype=torch.bfloat16)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = got.to(torch.float32).numpy()
    assert np.max(np.abs(got - want)) / np.abs(want).max() < 1e-5


def test_plain_matmul_dtype_none_is_f32():
    """``matmul_dtype=None`` is the f32 reference (the numpy f32 math to
    1e-5), and bf16 rounding moves it by far more than that."""
    args = _inputs(2, 40, 32, seed=4)
    ref = _numpy_reference(*args, 4)
    targs = [torch.from_numpy(a) for a in args]
    got = fused_qkv_attention_plain(*targs, 4, matmul_dtype=None).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    rounded = fused_qkv_attention_plain(*targs, 4, matmul_dtype=torch.bfloat16).numpy()
    assert np.abs(rounded - ref).max() > 1e-3


def test_plain_matches_numpy_f32():
    args = _inputs(2, 40, 32, seed=4)
    ref = _numpy_reference(*args, 4)
    got = fused_qkv_attention_plain(*(torch.from_numpy(a) for a in args), 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_cpu_dispatch_does_not_launch():
    args = [torch.from_numpy(a) for a in _inputs(1, 7, 16, seed=5)]
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(*args, 2)
    assert fused_qkv_attention.launches == before
    torch.testing.assert_close(got, fused_qkv_attention_plain(*args, 2),
                               rtol=0, atol=0)

