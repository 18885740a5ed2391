"""freud_tpu_torch's SAE sweeps against freud_tpu's: the sweep trainer's
members against solo trainers and against JAX's vmapped sweep, the grid's
per-model hyperparameters against JAX's independent-trainer oracles, the
fused chunk against per-step training, and ``train_hparam_sweep`` /
``train_sweep`` / the sweep CLI end to end (checkpoint names and ``hparams``
equal to JAX's, each package loading the other's).

Tolerances: a member against a solo port trainer on the CPU, and a fused
chunk against the same steps one by one, bit for bit (the same step body);
members against JAX after 5 steps in f32 (``amp=False``), and grid members
against JAX's solo trainers after 3, within 1e-4 of max |ref| (the trainer
tests' bar)."""

import json

import jax
import numpy as np
import pytest
import torch

from freud_tpu.data.store import ActivationStoreWriter
from freud_tpu.models.sae import sae_from_checkpoint as jax_sae_from_checkpoint
from freud_tpu.train import sweep as jsweep
from freud_tpu.train.trainer import SAETrainer as JaxTrainer
from freud_tpu_torch.data.device_cache import DeviceShuffleCache
from freud_tpu_torch.models.sae import (
    params_from_jax,
    sae_from_checkpoint,
    sweep_params_from_jax,
)
from freud_tpu_torch.scripts import sweep as sweep_cli
from freud_tpu_torch.train import sweep as tsweep
from freud_tpu_torch.train.sweep import SAESweepTrainer, expand_grid
from freud_tpu_torch.train.trainer import SAETrainer

D = 8
CFGS = {
    "l1": {"n_dict_components": 12, "recon_alpha": 10.0},
    # threshold 0: latents that did not fire in a step are dead after it, so
    # AuxK runs from step 2
    "topk": {"n_dict_components": 16, "k": 3, "auxk_alpha": 1 / 32,
             "dead_feature_threshold": 0.0},
}
KW = dict(optimizer="adam", scheduler="linear",
          scheduler_params={"num_warmup_steps": 1}, lr=1e-3, steps=10)


def _rel(a, b) -> float:
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _copy_params(dst_module, src_module) -> None:
    with torch.no_grad():
        for name, p in dst_module.named_parameters():
            p.copy_(getattr(src_module, name))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------ per-layer


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_members_equal_solo_port_trainers(variant):
    """Member i of a per-layer sweep is SAETrainer(seed + i) on batch i,
    bit for bit (bf16 matmuls: kernel #4's route through ``_FusedLosses``
    on the CPU's plain version)."""
    rng = np.random.default_rng(0)
    data = [rng.standard_normal((3, 4, 6, D)).astype(np.float32) for _ in range(3)]
    sweep = SAESweepTrainer(variant, CFGS[variant], D, 3, seed=5, device="cpu", **KW)
    for x in data:
        m = sweep.train_step(x)
    assert set(m) == set(sweep.metric_names) and all(v.shape == (3,) for v in m.values())
    assert sweep.step == 3
    for i in (0, 2):
        solo = SAETrainer(variant, CFGS[variant], D, seed=5 + i, **KW, device="cpu")
        for x in data:
            solo_m = solo.train_step(x[i])
        for a, b in zip(sweep.members[i]._state(), solo._state()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(m["loss"][i], solo_m["loss"], rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_sweep_matches_jax_sweep(variant):
    """Both sweeps start from JAX's stacked parameters
    (``sweep_params_from_jax``) and take 5 steps on the same (K, B, T, d)
    batches in f32."""
    rng = np.random.default_rng(1)
    data = [rng.standard_normal((3, 2, 5, D)).astype(np.float32) for _ in range(5)]
    jt = jsweep.SAESweepTrainer(variant, CFGS[variant], D, 3, amp=False, **KW)
    tt = SAESweepTrainer(variant, CFGS[variant], D, 3, amp=False, device="cpu", **KW)
    for member, src in zip(tt.members, sweep_params_from_jax(variant, _np_tree(jt.params))):
        _copy_params(member.params, src)
    for x in data:
        jm = jax.device_get(jt.train_step(x))
        tm = tt.train_step(x)
    for k in jm:
        assert _rel(tm[k], jm[k]) < 1e-4, k
    for i, member in enumerate(tt.members):
        for name, p in member.params.named_parameters():
            assert _rel(p, np.asarray(getattr(jt.params, name))[i]) < 1e-4, (i, name)
    if variant == "topk":
        np.testing.assert_array_equal(
            torch.stack([m.num_frames_since_fired for m in tt.members]).numpy(),
            np.asarray(jt.counters))


def test_sweep_params_from_jax_rows():
    rng = np.random.default_rng(2)
    stacked = {"encoder_weight": rng.standard_normal((2, 6, 4)),
               "encoder_bias": rng.standard_normal((2, 6)),
               "W_dec": rng.standard_normal((2, 6, 4)), "b_dec": rng.standard_normal((2, 4))}
    members = sweep_params_from_jax("topk", stacked)
    assert len(members) == 2
    for i, m in enumerate(members):
        one = params_from_jax("topk", {k: v[i] for k, v in stacked.items()})
        for name, p in m.named_parameters():
            torch.testing.assert_close(p, getattr(one, name), rtol=0, atol=0)
    with pytest.raises(ValueError, match="model axis"):
        sweep_params_from_jax("topk", {**stacked, "b_dec": stacked["b_dec"][:1]})


# ------------------------------------------------------------ grid


def _grid_against_jax_solos(variant, cfg, groups, optimizer, scheduler, lr):
    """Each group (one shared k) as one port sweep over the shared batches;
    member i of a group against JAX's solo trainer with its own
    hyperparameters and seed i, started from that trainer's parameters."""
    rng = np.random.default_rng(3)
    batches = [rng.standard_normal((2, 5, D)).astype(np.float32) for _ in range(3)]
    alpha = "recon_alpha" if variant == "l1" else "auxk_alpha"
    kw = dict(optimizer=optimizer, scheduler=scheduler,
              scheduler_params={"num_warmup_steps": 1}, steps=5, amp=False)
    for hps in groups:
        sweep = SAESweepTrainer(variant, cfg, D, len(hps), lr=lr, model_hparams=hps,
                                device="cpu", **kw)
        solos = []
        for i, hp in enumerate(hps):
            solo_cfg = {**cfg, alpha: hp.get(alpha, cfg[alpha])}
            if "k" in hp:
                solo_cfg["k"] = hp["k"]
            solo = JaxTrainer(variant, solo_cfg, D, lr=hp.get("lr", lr), seed=i, **kw)
            _copy_params(sweep.members[i].params, params_from_jax(
                variant, _np_tree(solo.params)))
            solos.append(solo)
        for x in batches:
            m = sweep.train_step_shared(x)
            solo_m = [jax.device_get(s.train_step(x)) for s in solos]
        for i, (hp, solo) in enumerate(zip(hps, solos)):
            for name, p in sweep.members[i].params.named_parameters():
                assert _rel(p, getattr(solo.params, name)) < 1e-4, (hp, name)
            assert _rel(m["loss"][i], solo_m[i]["loss"]) < 1e-4, hp


def test_grid_l1_lr_by_recon_alpha_matches_jax_solos():
    hps = expand_grid({"lr": [1e-3, 3e-3], "recon_alpha": [2.0, 25.0]})
    _grid_against_jax_solos("l1", CFGS["l1"], [hps], "radam", "cosine", 1e-3)


def test_grid_topk_k_by_auxk_alpha_by_lr_matches_jax_solos():
    combos = expand_grid({"k": [2, 3], "auxk_alpha": [0.0, 0.25], "lr": [1e-3, 2e-3]})
    groups = [[hp for hp in combos if hp["k"] == k] for k in (2, 3)]
    _grid_against_jax_solos("topk", CFGS["topk"], groups, "adam", "linear", 1e-3)


def test_grid_refusals():
    with pytest.raises(ValueError, match="unsupported"):
        SAESweepTrainer("l1", {"n_dict_components": 4}, D, 1,
                        model_hparams=[{"k": 2}], device="cpu")
    with pytest.raises(ValueError, match="share k"):
        SAESweepTrainer("topk", {"n_dict_components": 8, "k": 2}, D, 2,
                        model_hparams=[{"k": 2}, {"k": 4}], device="cpu")
    with pytest.raises(ValueError, match="hparam dicts"):
        SAESweepTrainer("l1", {"n_dict_components": 4}, D, 2,
                        model_hparams=[{"lr": 1e-3}], device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        SAESweepTrainer("l1", {"n_dict_components": 4}, D, 1, mesh=object(), device="cpu")
    # a one-process mesh: members on the mesh's card, each a data-parallel
    # trainer (the ranks' split is test_torch_distributed.py's)
    from freud_tpu_torch.parallel.mesh import Mesh

    sw = SAESweepTrainer("l1", {"n_dict_components": 4}, D, 2, mesh=Mesh("cpu"),
                         device="cuda")
    assert sw.device == torch.device("cpu") and all(m.mesh is sw.mesh for m in sw.members)


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_grid_members_are_solo_trainers(variant):
    """A grid member is a solo port trainer with its own lr, its own alpha
    in its config and seed + i: the same steps, bit for bit."""
    alpha = "recon_alpha" if variant == "l1" else "auxk_alpha"
    hps = [{"lr": 2e-3}, {"lr": 5e-4, alpha: 0.5}]
    sweep = SAESweepTrainer(variant, CFGS[variant], D, 2, model_hparams=hps, seed=7,
                            device="cpu", **KW)
    solos = [SAETrainer(variant, {**CFGS[variant], **{k: v for k, v in hp.items()
                                                     if k == alpha}},
                        D, seed=7 + i, device="cpu", **{**KW, "lr": hp["lr"]})
             for i, hp in enumerate(hps)]
    rng = np.random.default_rng(8)
    for _ in range(3):
        x = rng.standard_normal((2, 5, D)).astype(np.float32)
        m = sweep.train_step_shared(x)
        solo_m = [s.train_step(x) for s in solos]
    for i, solo in enumerate(solos):
        for a, b in zip(sweep.members[i]._state(), solo._state()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(m["loss"][i], solo_m[i]["loss"], rtol=0, atol=0)


# ------------------------------------------------------------ sweep functions


def _write_store(folder, layer, n_files=12, seed=0, t=6):
    rng = np.random.default_rng(seed)
    w = ActivationStoreWriter(folder, layer, (t, D), (t, D))
    w.append_batch([f"{layer}-f{i}" for i in range(n_files)],
                   rng.standard_normal((n_files, t, D)).astype(np.float32))
    w.close()


def _same_checkpoints(jdir, tdir, layer_for=None):
    """The same file names; hparams equal; each package loads the other's."""
    jfiles = sorted(p.name for p in jdir.glob("*.pth"))
    tfiles = sorted(p.name for p in tdir.glob("*.pth"))
    assert jfiles and tfiles == jfiles
    for name in tfiles:
        jck = torch.load(jdir / name, map_location="cpu", weights_only=False)
        tck = torch.load(tdir / name, map_location="cpu", weights_only=True)
        assert tck["hparams"] == jck["hparams"], name
        assert sorted(tck) == sorted(jck) and tck["step"] == jck["step"]
        assert sorted(tck["model"]) == sorted(jck["model"])
        jv, jcfg, jact, _ = jax_sae_from_checkpoint(str(tdir / name))
        tv, tcfg, tact, params = sae_from_checkpoint(str(jdir / name))
        assert (jv, jact) == (tv, tact)
        assert jcfg.k == tcfg.k if tv == "topk" else True
        assert all(torch.isfinite(p).all() for p in params.parameters())


GRID = {"lr": [1e-3, 2e-3], "k": [2, 4]}
GRID_AE = {"expansion_factor": 2, "dead_feature_threshold": 100.0}


def test_train_hparam_sweep_from_the_mmap_loader_matches_jax(tmp_path):
    layer = "encoder.blocks.0"
    _write_store(tmp_path, layer, seed=5)
    common = dict(grid=GRID, steps=3, batch_size=4,
                  scheduler_params={"num_warmup_steps": 1}, verbose=False)
    jstats = jsweep.train_hparam_sweep(str(tmp_path), layer, "topk", GRID_AE,
                                       out_dir=str(tmp_path / "jax"), **common)
    tstats = tsweep.train_hparam_sweep(str(tmp_path), layer, "topk", GRID_AE,
                                       out_dir=str(tmp_path / "torch"), device="cpu",
                                       **common)
    assert tstats["steps"] == jstats["steps"] == 3
    strip = [{k: v for k, v in m.items() if k != "final_loss"} for m in tstats["models"]]
    assert strip == [{k: v for k, v in m.items() if k != "final_loss"}
                     for m in jstats["models"]]
    assert all(np.isfinite(m["final_loss"]) for m in tstats["models"])
    _same_checkpoints(tmp_path / "jax", tmp_path / "torch")
    for m in tstats["models"]:
        _, cfg, _, _ = sae_from_checkpoint(str(tmp_path / "torch" / f"{m['tag']}.pth"))
        assert cfg.k == m["k"]  # the model's OWN grid value


def test_train_hparam_sweep_through_the_cache(tmp_path, monkeypatch):
    """Two chunks of 2 and a per-step tail of 1: every k-group trains on the
    identical index tensor of each chunk and the same tail batch; the
    checkpoints are JAX's (names and hparams)."""
    layer = "encoder.blocks.0"
    _write_store(tmp_path, layer, seed=6)
    seen = {"chunk": [], "step": []}
    chunk, step = SAESweepTrainer.train_chunk_shared, SAESweepTrainer.train_step_shared

    def chunk_spy(self, window, indices):
        seen["chunk"].append((self.cfg.k, indices))
        return chunk(self, window, indices)

    def step_spy(self, batch):
        seen["step"].append((self.cfg.k, batch))
        return step(self, batch)

    monkeypatch.setattr(SAESweepTrainer, "train_chunk_shared", chunk_spy)
    monkeypatch.setattr(SAESweepTrainer, "train_step_shared", step_spy)
    common = dict(grid=GRID, steps=5, batch_size=4,
                  scheduler_params={"num_warmup_steps": 1}, verbose=False,
                  device_cache_files=12, fused_steps=2)
    stats = tsweep.train_hparam_sweep(str(tmp_path), layer, "topk", GRID_AE,
                                      out_dir=str(tmp_path / "torch"), device="cpu",
                                      **common)
    assert stats["steps"] == 5 and len(stats["models"]) == 4
    assert all(np.isfinite(m["final_loss"]) for m in stats["models"])
    assert [k for k, _ in seen["chunk"]] == [2, 4, 2, 4]
    assert [k for k, _ in seen["step"]] == [2, 4]
    for calls in (seen["chunk"][:2], seen["chunk"][2:], seen["step"]):
        assert calls[0][1] is calls[1][1]
    assert not torch.equal(seen["chunk"][0][1], seen["chunk"][2][1])
    jsweep.train_hparam_sweep(str(tmp_path), layer, "topk", GRID_AE,
                              out_dir=str(tmp_path / "jax"), **common)
    _same_checkpoints(tmp_path / "jax", tmp_path / "torch")


@pytest.mark.parametrize("variant", ["l1", "topk"])
def test_fused_chunk_equals_per_step(tmp_path, variant):
    """Two chunks of 3 land where 6 per-step ``next_batch`` steps land, bit
    for bit: the same body, and the CPU generator's (3, 4) draw is three
    consecutive (1, 4) draws."""
    layer = "encoder.blocks.0"
    _write_store(tmp_path, layer, seed=4)
    hps = ([{"lr": 1e-3}, {"lr": 2e-3, "recon_alpha": 25.0}] if variant == "l1"
           else [{"lr": 1e-3}, {"lr": 2e-3, "auxk_alpha": 0.25}])
    out = {}
    for chunked in (False, True):
        sweep = SAESweepTrainer(variant, CFGS[variant], D, 2, model_hparams=hps,
                                device="cpu", **KW)
        cache = DeviceShuffleCache(str(tmp_path), layer, capacity_files=12,
                                   refresh_files=0, seed=9, device="cpu")
        try:
            if chunked:
                for _ in range(2):
                    m = sweep.train_chunk_shared(cache.sample_state()[0], cache.draw(3, 4))
            else:
                for _ in range(6):
                    m = sweep.train_step_shared(cache.next_batch(4))
        finally:
            cache.close()
        assert sweep.step == 6
        out[chunked] = (sweep._state(), m)
    for a, b in zip(out[False][0], out[True][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], v, rtol=0, atol=0)


def test_train_sweep_and_cli_match_jax(tmp_path, capsys):
    layers = ["encoder.blocks.0", "encoder.blocks.1"]
    for i, layer in enumerate(layers):
        _write_store(tmp_path, layer, seed=10 + i)
    cfg = {"data_path": str(tmp_path), "layer_names": layers, "variant": "topk",
           "autoencoder_config": {"expansion_factor": 2, "k": 2,
                                  "dead_feature_threshold": 100.0},
           "steps": 4, "batch_size": 4, "scheduler_params": {"num_warmup_steps": 1},
           "verbose": False}
    jstats = jsweep.train_sweep(**cfg, out_dir=str(tmp_path / "jax"))
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps({**cfg, "out_dir": str(tmp_path / "torch"),
                                "device": "cpu"}))
    sweep_cli.main(["--config", str(path)])
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tstats["steps"] == jstats["steps"] == 4
    assert sorted(tstats["final"]) == sorted(jstats["final"]) == ["fvu", "loss"]
    assert all(len(v) == 2 and np.isfinite(v).all() for v in tstats["final"].values())
    _same_checkpoints(tmp_path / "jax", tmp_path / "torch")
    for layer in layers:
        v, _, act, params = sae_from_checkpoint(str(tmp_path / "torch" / f"{layer}.pth"))
        assert v == "topk" and act == D and params.encoder_weight.shape == (16, D)
    # a grid runs over ONE store
    path.write_text(json.dumps({**cfg, "grid": {"lr": [1e-3]}, "layer_name": layers[0],
                                "out_dir": str(tmp_path / "g"), "device": "cpu"}))
    with pytest.raises(SystemExit, match="ONE store"):
        sweep_cli.main(["--config", str(path)])


def test_sweep_cli_grid_and_the_card_default(tmp_path, capsys, monkeypatch):
    """The grid form through the CLI on the CPU; without ``device`` the
    sweep functions ask for the card and raise here rather than run on the CPU."""
    layer = "encoder.blocks.0"
    _write_store(tmp_path, layer, seed=12)
    cfg = {"data_path": str(tmp_path), "layer_name": layer, "variant": "l1",
           "autoencoder_config": {"n_dict_components": 16, "recon_alpha": 100.0},
           "grid": {"lr": [1e-3, 4e-3], "recon_alpha": [10.0]}, "steps": 2,
           "batch_size": 4, "out_dir": str(tmp_path / "out"), "verbose": False}
    path = tmp_path / "grid.json"
    path.write_text(json.dumps({**cfg, "device": "cpu"}))
    sweep_cli.main(["--config", str(path)])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [m["tag"] for m in stats["models"]] == ["lr0.001_recon_alpha10",
                                                    "lr0.004_recon_alpha10"]
    for m in stats["models"]:
        ck = torch.load(tmp_path / "out" / f"{m['tag']}.pth", weights_only=True)
        assert ck["hparams"]["lr"] == m["lr"]
        assert ck["hparams"]["autoencoder_config"]["recon_alpha"] == 10.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path.write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        sweep_cli.main(["--config", str(path)])
