"""freud_tpu_torch's SAE models against freud_tpu's on shared parameters
(carried across with ``params_from_jax``) and seeded numpy inputs.

Tolerances: f32 forwards and losses within 1e-5 relative; bf16 within 2e-2;
``training_losses`` gradients within 1e-4 (f32) or 3e-2 (bf16) of max |ref|
— the three routes: the fused autograd Function over kernel #4 (bf16) or #3
(f32), and the autograd formulation over kernel #3 (multi_topk)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freud_tpu.models.sae import l1 as jl1
from freud_tpu.models.sae import serialize as jser
from freud_tpu.models.sae import topk as jtopk
from freud_tpu.models.sae.config import L1AutoEncoderConfig as JL1Config
from freud_tpu.models.sae.config import TopKAutoEncoderConfig as JTopKConfig
from freud_tpu_torch.models.sae import l1 as tl1
from freud_tpu_torch.models.sae import params_from_jax, sae_from_checkpoint
from freud_tpu_torch.models.sae import serialize as tser
from freud_tpu_torch.models.sae import topk as ttopk
from freud_tpu_torch.models.sae.config import TopKAutoEncoderConfig

D, N = 16, 128
REPO = Path(__file__).resolve().parent.parent


def test_config_rehomed_verbatim():
    """The framework-free config module is the JAX package's, unchanged."""
    assert (REPO / "freud_tpu_torch/models/sae/config.py").read_text() == \
        (REPO / "freud_tpu/models/sae/config.py").read_text()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f64(v):
    if torch.is_tensor(v):
        v = v.detach().float().numpy()
    return np.asarray(v, np.float64)


def _rel(a, b):
    a, b = _f64(a), _f64(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _topk_params(seed=1):
    rng = np.random.default_rng(seed)
    jp = jtopk.init_topk(D, JTopKConfig(n_dict_components=N), seed=seed)
    return jp._replace(
        encoder_bias=jnp.asarray(rng.standard_normal(N) * 0.1, jnp.float32),
        b_dec=jnp.asarray(rng.standard_normal(D) * 0.1, jnp.float32))


def _x(seed=0, b=3, t=10):
    return np.random.default_rng(seed).standard_normal((b, t, D)).astype(np.float32)


ROUTES = [  # (multi_topk, JAX matmul dtype, port matmul dtype, grad tolerance)
    (False, jnp.bfloat16, torch.bfloat16, 3e-2),
    (False, None, None, 1e-4),
    (True, jnp.bfloat16, torch.bfloat16, 3e-2),
    (True, None, None, 1e-4),
]


@pytest.mark.parametrize("multi,jmm,tmm,tol", ROUTES,
                         ids=["fused-bf16", "fused-f32", "multi-bf16", "multi-f32"])
def test_training_losses_and_grads_match_jax(multi, jmm, tmm, tol):
    cfg = JTopKConfig(n_dict_components=N, k=4, auxk_alpha=1 / 32, multi_topk=multi)
    jp = _topk_params()
    x = _x()
    dead = np.random.default_rng(2).random(N) < 0.4

    def loss_fn(p):
        terms, fired = jtopk.training_losses(p, jnp.asarray(x), cfg,
                                             jnp.asarray(dead), matmul_dtype=jmm)
        return terms["fvu"] + terms["auxk_loss"] + terms["multi_topk_fvu"] / 8, (terms, fired)

    (jloss, (jterms, jfired)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    tp = params_from_jax("topk", _np(jp))
    terms, fired = ttopk.training_losses(
        tp, torch.from_numpy(x), TopKAutoEncoderConfig(**cfg.to_dict()),
        torch.from_numpy(dead), matmul_dtype=tmm)
    loss = terms["fvu"] + terms["auxk_loss"] + terms["multi_topk_fvu"] / 8
    loss.backward()
    loss_tol = 1e-5 if tmm is None else 2e-2
    for k in ("fvu", "auxk_loss", "multi_topk_fvu"):
        got, want = terms[k].item(), float(jterms[k])
        assert abs(got - want) <= loss_tol * max(abs(want), 1e-6), k
    assert terms["auxk_loss"].item() > 0
    np.testing.assert_array_equal(fired.numpy(), np.asarray(jfired))
    for name in ("encoder_weight", "encoder_bias", "W_dec", "b_dec"):
        assert _rel(getattr(tp, name).grad, getattr(jgrads, name)) < tol, name


def test_training_losses_match_jax_large_recipe_route():
    """JAX sends recipes whose bf16 W_enc + W_dec exceed its kernel's VMEM
    budget (the large recipes: d_in 1280 × n_dict 20480) to "XLA encode +
    thresholds kernel" (``prefer_kernel=False`` forces that route at any
    width); the port sends every width to kernel #4. Both compute
    relu(bf16(bf16(z) + bf16(b_enc))) with the exact bf16 selection and
    bf16 × bf16 → f32 decodes: the same losses, fired mask and gradients,
    at the bf16 tolerances of ``test_training_losses_and_grads_match_jax``."""
    d, n = 32, 256
    cfg = JTopKConfig(n_dict_components=n, k=4, auxk_alpha=1 / 32)
    rng = np.random.default_rng(6)
    jp = jtopk.init_topk(d, cfg, seed=6)._replace(
        encoder_bias=jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32),
        b_dec=jnp.asarray(rng.standard_normal(d) * 0.1, jnp.float32))
    x = rng.standard_normal((3, 10, d)).astype(np.float32)
    dead = rng.random(n) < 1 / 3

    def loss_fn(p):
        terms, fired = jtopk.training_losses(p, jnp.asarray(x), cfg, jnp.asarray(dead),
                                             matmul_dtype=jnp.bfloat16,
                                             prefer_kernel=False)
        return terms["fvu"] + terms["auxk_loss"], (terms, fired)

    (_, (jterms, jfired)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    tp = params_from_jax("topk", _np(jp))
    terms, fired = ttopk.training_losses(
        tp, torch.from_numpy(x), TopKAutoEncoderConfig(**cfg.to_dict()),
        torch.from_numpy(dead), matmul_dtype=torch.bfloat16)
    (terms["fvu"] + terms["auxk_loss"]).backward()
    for k in ("fvu", "auxk_loss"):
        got, want = terms[k].item(), float(jterms[k])
        assert abs(got - want) <= 2e-2 * abs(want), k
    assert terms["auxk_loss"].item() > 0
    np.testing.assert_array_equal(fired.numpy(), np.asarray(jfired))
    for name in ("encoder_weight", "encoder_bias", "W_dec", "b_dec"):
        assert _rel(getattr(tp, name).grad, getattr(jgrads, name)) < 3e-2, name


@pytest.mark.parametrize("bf16", [False, True])
def test_fused_input_gradient_matches_jax(bf16):
    """∂L/∂x through the hand-written backward (only computed when asked)."""
    cfg = JTopKConfig(n_dict_components=N, k=4, auxk_alpha=1 / 32)
    jp = _topk_params(3)
    x = _x(4)
    dead = np.random.default_rng(5).random(N) < 0.3
    jmm = jnp.bfloat16 if bf16 else None

    def loss_fn(xx):
        terms, _ = jtopk.training_losses(jp, xx, cfg, jnp.asarray(dead), matmul_dtype=jmm)
        return terms["fvu"] + terms["auxk_loss"]

    jdx = jax.grad(loss_fn)(jnp.asarray(x))
    tp = params_from_jax("topk", _np(jp))
    tx = torch.from_numpy(x).requires_grad_(True)
    terms, _ = ttopk.training_losses(tp, tx, TopKAutoEncoderConfig(**cfg.to_dict()),
                                     torch.from_numpy(dead),
                                     matmul_dtype=torch.bfloat16 if bf16 else None)
    (terms["fvu"] + terms["auxk_loss"]).backward()
    assert _rel(tx.grad, jdx) < (3e-2 if bf16 else 1e-4)


@pytest.mark.parametrize("multi", [False, True])
def test_forward_validation_path_matches_jax(multi):
    cfg = JTopKConfig(n_dict_components=N, k=4, auxk_alpha=1 / 32, multi_topk=multi)
    jp = _topk_params(6)
    x = _x(7, b=2)
    dead = np.random.default_rng(8).random(N) < 0.4
    jout, jfired = jtopk.forward_with_fired(jp, jnp.asarray(x), cfg, jnp.asarray(dead))
    tp = params_from_jax("topk", _np(jp))
    with torch.no_grad():
        out, fired = ttopk.forward_with_fired(
            tp, torch.from_numpy(x), TopKAutoEncoderConfig(**cfg.to_dict()),
            torch.from_numpy(dead))
    np.testing.assert_array_equal(out.encoded.top_indices.numpy(),
                                  np.asarray(jout.encoded.top_indices))
    assert _rel(out.encoded.top_acts, jout.encoded.top_acts) < 1e-5
    assert _rel(out.sae_out, jout.sae_out) < 1e-5
    for k in ("fvu", "auxk_loss", "multi_topk_fvu"):
        assert _rel(getattr(out, k), getattr(jout, k)) < 1e-5, k
    np.testing.assert_array_equal(fired.numpy(), np.asarray(jfired))


def test_topk_pieces_match_jax():
    jp = _topk_params(9)
    tp = params_from_jax("topk", _np(jp))
    rng = np.random.default_rng(10)
    lat = np.maximum(rng.standard_normal((5, N)), 0).astype(np.float32)
    lat[0] = 0.0  # ties: lax.top_k's order is the lower index first
    lat[1, ::2] = 1.0
    for k in (4, 64):
        jsel = jtopk.select_topk(jnp.asarray(lat), k)
        tsel = ttopk.select_topk(torch.from_numpy(lat), k)
        np.testing.assert_array_equal(tsel.top_indices.numpy(), np.asarray(jsel.top_indices))
        np.testing.assert_array_equal(tsel.top_acts.numpy(), np.asarray(jsel.top_acts))
        # both decode regimes: gather (k·d ≤ n_dict) and dense
        jy = jtopk.decode(jp, jsel.top_acts, jsel.top_indices)
        with torch.no_grad():
            ty = ttopk.decode(tp, tsel.top_acts, tsel.top_indices)
        assert _rel(ty, jy) < 1e-5
        np.testing.assert_allclose(
            ttopk.dense_latent(tsel.top_acts, tsel.top_indices, N).numpy(),
            np.asarray(jtopk.dense_latent(jsel.top_acts, jsel.top_indices, N)))
    mask = rng.random((5, N)) < 0.5
    for m in (None, mask):
        jt = jtopk.kth_threshold(jnp.asarray(lat), 7, None if m is None else jnp.asarray(m))
        tt = ttopk.kth_threshold(torch.from_numpy(lat), 7,
                                 None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    w = rng.standard_normal((N, D)).astype(np.float32)
    np.testing.assert_allclose(
        ttopk.set_decoder_norm_to_unit_norm(torch.from_numpy(w)).numpy(),
        np.asarray(jtopk.set_decoder_norm_to_unit_norm(jnp.asarray(w))), rtol=1e-6)
    assert ttopk.param_count(tp) == jtopk.param_count(jp)


def test_remove_gradient_parallel_to_decoder_directions_matches_jax():
    """The public helper against JAX's, at the reference test's
    tolerance; the result is orthogonal to each (unit) decoder row."""
    rng = np.random.default_rng(12)
    w = rng.standard_normal((N, D)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    grad = rng.standard_normal((N, D)).astype(np.float32)
    got = ttopk.remove_gradient_parallel_to_decoder_directions(
        torch.from_numpy(w), torch.from_numpy(grad)).numpy()
    want = np.asarray(jtopk.remove_gradient_parallel_to_decoder_directions(
        jnp.asarray(w), jnp.asarray(grad)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(np.sum(got * w, axis=1)).max() < 1e-5


def test_dead_counters_match_jax():
    rng = np.random.default_rng(11)
    counter = rng.integers(0, 2 ** 30, N).astype(np.int32)
    counter[:3] = 2 ** 30 - 5  # saturates at 2^30
    fired = rng.random(N) < 0.3
    idx = rng.integers(0, N, (4, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        ttopk.age_counters(torch.from_numpy(counter), torch.from_numpy(fired), 75000).numpy(),
        np.asarray(jtopk.age_counters(jnp.asarray(counter), jnp.asarray(fired), 75000)))
    np.testing.assert_array_equal(
        ttopk.update_fired_counters(torch.from_numpy(counter), torch.from_numpy(idx), 9).numpy(),
        np.asarray(jtopk.update_fired_counters(jnp.asarray(counter), jnp.asarray(idx), 9)))


@pytest.mark.parametrize("bf16", [False, True])
def test_l1_forward_and_grads_match_jax(bf16):
    cfg = JL1Config(n_dict_components=24, recon_alpha=10.0)
    jp = jl1.init_l1(D, cfg, seed=2)
    jp = jp._replace(encoder_bias=jnp.asarray(
        np.random.default_rng(3).standard_normal(24) * 0.1, jnp.float32))
    x = _x(12)
    x[0, :3, :4] = -1.0  # masked_mse ignores −1 targets
    jmm, tmm = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)

    def loss_fn(p):
        out = jl1.forward(p, jnp.asarray(x), cfg, matmul_dtype=jmm)
        return out.reconstruction_loss + out.l1_loss, out

    (_, jout), jg = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    tp = params_from_jax("l1", _np(jp))
    out = tl1.forward(tp, torch.from_numpy(x), cfg, matmul_dtype=tmm)
    (out.reconstruction_loss + out.l1_loss).backward()
    assert out.encoded.latent.dtype == (torch.bfloat16 if bf16 else torch.float32)
    tol = 2e-2 if bf16 else 1e-5
    assert _rel(out.sae_out, jout.sae_out) < tol
    assert _rel(out.encoded.latent.float(), jnp.asarray(jout.encoded.latent, jnp.float32)) < tol
    assert _rel(out.reconstruction_loss, jout.reconstruction_loss) < tol
    assert _rel(out.l1_loss, jout.l1_loss) < tol
    gtol = 3e-2 if bf16 else 1e-4
    assert _rel(tp.W.grad, jg.W) < gtol and _rel(tp.encoder_bias.grad, jg.encoder_bias) < gtol
    normed = tl1.normalize_columns(tp).W.detach().numpy()
    np.testing.assert_allclose(normed, np.asarray(jl1.normalize_columns(jp).W), rtol=1e-6)
    assert tl1.param_count(tp) == jl1.param_count(jp)


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_state_dict_and_checkpoint_interchange(tmp_path, variant):
    """Reference key names; a JAX-written SAE checkpoint loads in the port
    and the port's in JAX, values unchanged."""
    if variant == "l1":
        cfg = JL1Config(n_dict_components=20, recon_alpha=2.0)
        jp = jl1.init_l1(8, cfg, seed=1)
    else:
        cfg = JTopKConfig(expansion_factor=4, k=3)
        jp = jtopk.init_topk(8, cfg, seed=1)
    tp = params_from_jax(variant, _np(jp))
    tsd, jsd = tser.state_dict_from_params(variant, tp), jser.state_dict_from_params(variant, jp)
    assert tsd.keys() == jsd.keys()
    for k in tsd:
        assert tsd[k].dtype == jsd[k].dtype == torch.float32
        np.testing.assert_array_equal(tsd[k].numpy(), jsd[k].numpy())
    hp = {"autoencoder_variant": variant, "autoencoder_config": cfg.to_dict(),
          "activation_size": 8}
    for writer, reader in ((jser, tser), (tser, jser)):
        path = tmp_path / f"{writer.__name__}.pth"
        sd = jsd if writer is jser else tsd
        writer.save_checkpoint(str(path), {"model": sd, "hparams": hp})
        v, rcfg, act, params = reader.sae_from_checkpoint(str(path))
        assert v == variant and act == 8 and rcfg.to_dict() == cfg.to_dict()
        for k, val in reader.state_dict_from_params(variant, params).items():
            np.testing.assert_array_equal(np.asarray(val), jsd[k].numpy())
    v, _, _, module = sae_from_checkpoint(str(tmp_path / f"{jser.__name__}.pth"))
    assert isinstance(module, torch.nn.Module)
