"""freud_tpu_torch over two ranks: torch.distributed with gloo on the CPU.

One module fixture spawns two gloo ranks once (``_WORKER``, in the style of
tests/test_distributed.py). Each rank runs every data-parallel path of the
port on its half of the work and saves what it computed; meanwhile this
process computes the oracles: the port's one-process runs on the same
global batches and JAX's counterparts on a two-device mesh. Everything runs
f32 with ``amp`` off. The bars:

* the pod train step (TopK with AuxK live, multi_topk, L1) against the
  port's one-process step: 1e-6 of max after 1 step, 1e-5 after 5, the
  dead counters equal on both ranks and to the one-process ones; against
  JAX's ``SAETrainer`` on ``make_mesh(n_devices=2)`` (parameters through
  ``params_from_jax``): 1e-4 of max after 5 steps;
* ``train(mesh=)`` from a store against the one-process ``train()`` and
  JAX's ``train()`` on a two-device mesh (1e-4 of the model's max |param|
  each; JAX's own
  tests/test_distributed.py holds its two-process run to that mesh run),
  both from one JAX-initialised start checkpoint; artifacts on rank 0 only;
* ``train_chunk_pod`` bit-equal to its steps run one by one, and the
  ``process_shard`` strata disjoint and covering the store;
* ``data_parallel`` collection (single- and multi-layer) merged by the
  port's ``merge_stores``: metadata identical to a one-rank collection's
  and to JAX's merged shards', stores within 1e-6 of max of the one-rank
  store and 1e-4 of JAX's;
* ``top_activations(mesh=)`` bit-equal to the one-rank answer and JAX's;
* the sweep step with ``mesh``: 1e-6 of max of the one-process sweep,
  1e-4 of JAX's sweep on a two-device mesh.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
N_FILES, T, D, B, STEPS = 8, 6, 8, 4, 5
TOPK = {"expansion_factor": 2, "k": 2, "auxk_alpha": 1 / 32, "dead_feature_threshold": 6}
VARIANTS = {
    "topk": ("topk", TOPK),
    "multi_topk": ("topk", {**TOPK, "multi_topk": True}),
    "l1": ("l1", {"n_dict_components": 16, "recon_alpha": 2.0}),
}
TRAINER_KW = dict(optimizer="adam", scheduler="linear",
                  scheduler_params={"num_warmup_steps": 1}, lr=1e-2, steps=12,
                  clip_thresh=1.0, seed=3, amp=False)
LAYER, LAYERS = "encoder.blocks.1", ["encoder.blocks.0", "encoder.blocks.1"]
WHISPER = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4,
               n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
               n_text_head=4, n_text_layer=1)
SEARCH_FEATS = (0, 5, 11)
SEARCH_QUERIES = ({}, {"absolute_magnitude": True})
WORKER_TIMEOUT_S = 240


def global_batches():
    return np.random.default_rng(11).standard_normal((STEPS, B, T, D)).astype(np.float32)


def train_config(root, run_dir, **over):
    cfg = dict(seed=0, train_folder=str(root / "store"), val_folder=str(root / "store"),
               run_dir=str(run_dir), lr=1e-3, weight_decay=0.0, steps=6, clip_thresh=1.0,
               batch_size=4, log_tb_every=100, save_every=100, val_every=3,
               whisper_config={"model": "test:tiny", "layer_name": "L"},
               optimizer="adam", scheduler="linear",
               scheduler_params={"num_warmup_steps": 1},
               autoencoder_variant="l1",
               autoencoder_config={"expansion_factor": 2, "recon_alpha": 2.0},
               from_disk=True, start_checkpoint=str(root / "start.pth"),
               enable_transcripts=False, verbose=False)
    cfg.update(over)
    return cfg


_WORKER = r'''
import os, pickle, sys
from pathlib import Path
rank, port, root = int(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
sys.path.insert(0, sys.argv[4])
import numpy as np
import torch
torch.set_num_threads(1)
from tests.test_torch_distributed import (B, D, LAYER, LAYERS, SEARCH_FEATS, SEARCH_QUERIES,
                                          STEPS, T, TRAINER_KW, VARIANTS, global_batches,
                                          train_config)
from freud_tpu_torch.parallel import distributed as dist_lib, mesh as mesh_lib

dist_lib.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu", timeout_s=120)
mesh = mesh_lib.make_mesh(device="cpu")
assert dist_lib.process_info()["process_count"] == 2 and mesh.rank == rank
assert dist_lib.is_main_process() == (rank == 0)
lo, hi = mesh_lib.host_shard_bounds(B, mesh)
out = {"bounds": (lo, hi)}

from freud_tpu_torch.models.sae import params_from_jax
from freud_tpu_torch.train.trainer import SAETrainer, DeviceValSet, train

def state(tr):
    return [t.detach().clone() for t in tr._state()]

# 1. the pod train step, from JAX's initial parameters
xs = global_batches()
for name, (variant, cfg) in VARIANTS.items():
    init = pickle.loads((root / f"init_{name}.pkl").read_bytes())
    tr = SAETrainer(variant, cfg, D, mesh=mesh, **TRAINER_KW)
    with torch.no_grad():
        for n, p in tr.params.named_parameters():
            p.copy_(getattr(params_from_jax(variant, init), n))
    tr2 = SAETrainer(variant, cfg, D, mesh=mesh, **TRAINER_KW)
    with torch.no_grad():
        for n, p in tr2.params.named_parameters():
            # rank 1 starts from zeros: broadcast_ hands it rank 0's
            p.copy_(getattr(params_from_jax(variant, init), n) if rank == 0 else p * 0)
    mesh_lib.broadcast_(mesh, list(tr2.params.parameters()))
    rec = {"metrics": [], "counters": []}
    for i in range(STEPS):
        m = tr.train_step(xs[i, lo:hi], host_local=True)
        # the same step from the GLOBAL batch: this rank takes its slice
        tr2.train_step(xs[i])
        rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["counters"].append(tr.num_frames_since_fired.clone())
        if i == 0:
            rec["state1"] = state(tr)
    rec["state5"] = state(tr)
    rec["state5_global"] = state(tr2)
    out[f"step_{name}"] = rec

# a trainer's parameters start as rank 0's, whatever a rank's seed
out["seeded"] = state(SAETrainer("l1", VARIANTS["l1"][1], D, mesh=mesh,
                                 **{**TRAINER_KW, "seed": rank}))[:2]

# 2. train(mesh=) from the store: rank-0 artifacts
stats = train(**train_config(root, root / "pod" / f"p{rank}", mesh=mesh))
out["train_steps"] = stats["steps"]
out["train_files"] = sorted(str(p.relative_to(root / "pod" / f"p{rank}"))
                            for p in (root / "pod" / f"p{rank}").rglob("*") if p.is_file())

# 3. the pod cache, its chunk against its steps, and train() through it
from freud_tpu_torch.data.device_cache import DeviceShuffleCache, sample_rows
caches = [DeviceShuffleCache(str(root / "store"), "L", 8, refresh_files=0, seed=7,
                             process_shard=(rank, 2), device="cpu") for _ in range(2)]
out["stratum"] = caches[0]._files.tolist()
idx = caches[0].draw(STEPS, B // 2)
init = pickle.loads((root / "init_topk.pkl").read_bytes())
runs = []
for chunked, cache in zip((True, False), caches):
    tr = SAETrainer("topk", VARIANTS["topk"][1], D, mesh=mesh, **TRAINER_KW)
    with torch.no_grad():
        for n, p in tr.params.named_parameters():
            p.copy_(getattr(params_from_jax("topk", init), n))
    if chunked:
        ms = tr.train_chunk_pod(cache, B // 2, STEPS, indices=idx)
        last = {k: v[-1] for k, v in ms.items()}
    else:
        for i in range(STEPS):
            last = tr.train_step(sample_rows(cache.cache, idx[i]), host_local=True)
    runs.append((state(tr), last))
out["chunk"], out["per_step"] = runs
stats = train(**train_config(root, root / "pod_cache" / f"p{rank}", mesh=mesh,
                             device_cache_files=8, fused_steps=3, steps=6, val_every=6,
                             save_every=6, start_checkpoint=None))
out["cache_steps"] = stats["steps"]
out["cache_files"] = sorted(p.name for p in (root / "pod_cache" / f"p{rank}").rglob("*.pth"))

# 4. the resident validation set on the mesh
from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader, FlyActivationLoader
loader = MemoryMappedActivationLoader(str(root / "store"), "L", 3)
vs = DeviceValSet(loader, mesh=mesh)
out["val_set"] = [(x.clone(), n, f) for x, n, f in vs]

# 5. data_parallel collection, one layer and two
os.environ["FREUD_WHISPER_DIR"] = str(root / "whisper")
from freud_tpu_torch.scripts.collect_activations import get_activations
from freud_tpu_torch.data.multilayer import collect_multilayer
get_activations(data_path=str(root / "audio"), layer_name=LAYER, whisper_model="tiny",
                sae_model=None, batch_size=2, out_folder=str(root / "dp"), verbose=False,
                data_parallel=True, device="cpu")
collect_multilayer(str(root / "audio"), LAYERS, "tiny", 2, str(root / "dpm"),
                   verbose=False, data_parallel=True, device="cpu")

# 6. the fly loader splitting each batch's encode over the ranks
fly = FlyActivationLoader(str(root / "audio"), "tiny", None, LAYER, 2, mesh=mesh)
out["fly"] = [(a, list(f)) for a, f in fly]

# 7. search over the ranks
from freud_tpu_torch.analysis.search import top_activations
for kind in ("dense_f32", "indexed"):
    for where in ("scan", "fast"):
        ld = MemoryMappedActivationLoader(str(root / f"search_{kind}_{where}"),
                                          "encoder.blocks.2", batch_size=3)
        out[f"search_{kind}_{where}"] = [
            top_activations(ld, f, 4, mesh=mesh, **q)
            for f in SEARCH_FEATS for q in SEARCH_QUERIES]

# 8. a two-member sweep step
from freud_tpu_torch.models.sae import sweep_params_from_jax
from freud_tpu_torch.train.sweep import SAESweepTrainer
sw = SAESweepTrainer("topk", VARIANTS["topk"][1], D, 2, mesh=mesh,
                     **{**TRAINER_KW, "seed": 5})
members = sweep_params_from_jax("topk", pickle.loads((root / "init_sweep.pkl").read_bytes()))
with torch.no_grad():
    for m, src in zip(sw.members, members):
        for n, p in m.params.named_parameters():
            p.copy_(getattr(src, n))
sw.train_step(np.stack([xs[0], xs[1]]))
out["sweep"] = [state(m) for m in sw.members]

dist_lib.barrier()
(root / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
dist_lib.shutdown()
'''


def _write_wav(path, seconds, seed):
    audio = (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
             * 0.1).astype(np.float32)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((audio * 32767).astype(np.int16).tobytes())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_tree(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _jax_trainer(variant, cfg, mesh):
    from freud_tpu.train.trainer import SAETrainer as JaxTrainer

    return JaxTrainer(variant, cfg, D, mesh=mesh, **TRAINER_KW)


def _port_trainer(variant, cfg, init):
    from freud_tpu_torch.models.sae import params_from_jax
    from freud_tpu_torch.train.trainer import SAETrainer

    tr = SAETrainer(variant, cfg, D, **TRAINER_KW, device="cpu")
    with torch.no_grad():
        for n, p in tr.params.named_parameters():
            p.copy_(getattr(params_from_jax(variant, init), n))
    return tr


def _prepare(root: Path, jmesh):
    """The inputs both sides read: JAX-initialised parameters, a store, a
    start checkpoint, WAVs and narrow Whisper weights, the search stores."""
    import jax

    from freud_tpu.data.store import ActivationStoreWriter
    from freud_tpu.models.whisper.config import WhisperDims as JaxDims
    from freud_tpu.models.whisper.model import init_params
    from freud_tpu.train import sweep as jsweep
    from freud_tpu_torch.data import feature_store as tfs
    from freud_tpu_torch.models.whisper import WhisperDims, state_dict_from_jax
    from tests.test_torch_feature_store import build, write_store

    jtrainers = {}
    for name, (variant, cfg) in VARIANTS.items():
        jtrainers[name] = _jax_trainer(variant, cfg, jmesh)
        (root / f"init_{name}.pkl").write_bytes(pickle.dumps(_np_tree(jtrainers[name].params)))
    jsw = jsweep.SAESweepTrainer("topk", VARIANTS["topk"][1], D, 2, mesh=jmesh,
                                 **{**TRAINER_KW, "seed": 5})
    (root / "init_sweep.pkl").write_bytes(pickle.dumps(_np_tree(jsw.params)))

    rng = np.random.default_rng(0)
    w = ActivationStoreWriter(root / "store", "L", (T, D), (T, D))
    w.append_batch([f"f{i}" for i in range(N_FILES)],
                   rng.standard_normal((N_FILES, T, D)).astype(np.float32))
    w.close()
    start = _jax_trainer("l1", train_config(root, "")["autoencoder_config"], jmesh)
    start.save(str(root / "start.pth"), start.hparams())

    (root / "whisper").mkdir()
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    init_params(JaxDims(**WHISPER), seed=2)),
                             WhisperDims(**WHISPER))
    torch.save({"dims": dict(WHISPER), "model_state_dict": sd}, root / "whisper" / "tiny.pt")
    (root / "audio").mkdir()
    for i, secs in enumerate((2.0, 0.7, 1.3)):
        _write_wav(root / "audio" / f"clip{i}.wav", secs, i)

    for kind in ("dense_f32", "indexed"):
        for where in ("scan", "fast"):
            folder = root / f"search_{kind}_{where}"
            write_store(folder, kind, 11, seed=1)
            if where == "fast":
                build(tfs, folder, kind)
    return jtrainers, jsw


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Spawn the two ranks, compute the oracles meanwhile, collect both."""
    from freud_tpu.parallel import mesh as jmesh_lib

    root = tmp_path_factory.mktemp("pod")
    t0 = time.perf_counter()
    jmesh = jmesh_lib.make_mesh(n_devices=2)
    jtrainers, jsw = _prepare(root, jmesh)
    worker = root / "worker.py"
    worker.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(port), str(root),
                               str(REPO)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(2)]
    try:
        oracles = _oracles(root, jmesh, jtrainers, jsw)
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o}"
    ranks = [pickle.loads((root / f"rank{r}.pkl").read_bytes()) for r in range(2)]
    print(f"two ranks and the oracles in {time.perf_counter() - t0:.1f} s")
    return root, ranks, oracles


def _oracles(root: Path, jmesh, jtrainers, jsw) -> dict:
    """The port's one-process runs and JAX's mesh runs on the same inputs."""
    from freud_tpu.train.trainer import train as jax_train
    from freud_tpu_torch.train.trainer import train

    xs = global_batches()
    out = {}
    for name, (variant, cfg) in VARIANTS.items():
        init = pickle.loads((root / f"init_{name}.pkl").read_bytes())
        tr = _port_trainer(variant, cfg, init)
        rec = {"metrics": [], "counters": []}
        for i in range(STEPS):
            m = tr.train_step(xs[i])
            rec["metrics"].append({k: float(v) for k, v in m.items()})
            rec["counters"].append(tr.num_frames_since_fired.clone())
            jtrainers[name].train_step(xs[i])
            if i == 0:
                rec["state1"] = [t.detach().clone() for t in tr._state()]
        rec["state5"] = [t.detach().clone() for t in tr._state()]
        rec["jax5"] = _np_tree(jtrainers[name].params)
        rec["jax_counters"] = np.asarray(jtrainers[name].num_frames_since_fired)
        out[f"step_{name}"] = rec
    train(**train_config(root, root / "one", device="cpu"))
    jax_train(**train_config(root, root / "jax", mesh=jmesh))
    jsw.train_step(np.stack([xs[0], xs[1]]))
    out["jax_sweep"] = _np_tree(jsw.params)
    return out


def _max_rel(a, b) -> float:
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _n_params(variant):
    return 2 if variant == "l1" else 4


@pytest.mark.parametrize("name", list(VARIANTS))
def test_pod_step_matches_one_process(pod, name):
    """Trap 1 (the normalisers are whole-batch statistics) and trap 2
    (``fired`` is the OR over the whole batch): parameters within 1e-6 of
    max after one step and 1e-5 after five, the dead counters identical on
    both ranks and to the one-process ones after every step, the logged
    metrics the global ones."""
    _, ranks, oracles = pod
    want = oracles[f"step_{name}"]
    n = _n_params(VARIANTS[name][0])
    for r in ranks:
        got = r[f"step_{name}"]
        for a, b in zip(got["state1"][:n], want["state1"][:n]):
            assert _max_rel(a, b) < 1e-6
        for a, b in zip(got["state5"][:n], want["state5"][:n]):
            assert _max_rel(a, b) < 1e-5
        # the step from the global batch (put_batch's slice) is the same step
        for a, b in zip(got["state5_global"], got["state5"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for c_got, c_want, c_other in zip(got["counters"], want["counters"],
                                          ranks[0][f"step_{name}"]["counters"]):
            torch.testing.assert_close(c_got, c_other, rtol=0, atol=0)
            torch.testing.assert_close(c_got, c_want, rtol=0, atol=0)
        for m_got, m_want in zip(got["metrics"], want["metrics"]):
            for k, v in m_want.items():
                assert m_got[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    if VARIANTS[name][0] == "topk":
        assert max(m["auxk_loss"] for m in want["metrics"][1:]) > 0, "AuxK never ran"


def test_trainer_starts_from_rank_0(pod):
    """``SAETrainer(mesh=)`` broadcasts rank 0's parameters at start: two
    ranks seeded differently hold the seed-0 trainer's parameters."""
    from freud_tpu_torch.train.trainer import SAETrainer

    _, ranks, _ = pod
    want = SAETrainer("l1", VARIANTS["l1"][1], D, **{**TRAINER_KW, "seed": 0}, device="cpu")
    for r in ranks:
        for a, b in zip(r["seeded"], want._state()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_pod_step_matches_jax_mesh(pod, name):
    """Against JAX's ``SAETrainer`` on a two-device mesh: 1e-4 of max after
    five steps, the counters equal."""
    _, ranks, oracles = pod
    want = oracles[f"step_{name}"]
    fields = (("W", "encoder_bias") if VARIANTS[name][0] == "l1"
              else ("encoder_weight", "encoder_bias", "W_dec", "b_dec"))
    for i, field in enumerate(fields):
        assert _max_rel(ranks[0][f"step_{name}"]["state5"][i], want["jax5"][field]) < 1e-4
    np.testing.assert_array_equal(ranks[1][f"step_{name}"]["counters"][-1].numpy(),
                                  want["jax_counters"])


def test_pod_train_matches_one_process_and_jax(pod):
    """``train(mesh=)``: both ranks ran the steps; checkpoints, TensorBoard
    and validation on rank 0 only; the final checkpoint within 1e-4 of the
    model's max |param| of the one-process ``train()`` and of JAX's on a
    two-device mesh."""
    root, ranks, _ = pod
    assert ranks[0]["train_steps"] == ranks[1]["train_steps"] == 6
    assert "checkpoints/step6.pth" in ranks[0]["train_files"]
    assert "checkpoints/bestval.pth" in ranks[0]["train_files"]
    assert any(f.startswith("events.out.tfevents") for f in ranks[0]["train_files"])
    assert ranks[1]["train_files"] == []
    pod_ck = torch.load(root / "pod" / "p0" / "checkpoints" / "step6.pth", weights_only=True)
    one = torch.load(root / "one" / "checkpoints" / "step6.pth", weights_only=True)
    jck = torch.load(root / "jax" / "checkpoints" / "step6.pth", weights_only=True)
    # the trainer-parameter bar, 1e-4 of the model's max |param| in f32:
    # six Adam steps carry summation-order rounding to ~1.2e-5 of it here,
    # as far as the one-process port is from JAX
    top = max(float(v.abs().max()) for v in one["model"].values())
    for k, v in pod_ck["model"].items():
        for ref in (one, jck):
            assert float((v - ref["model"][k]).abs().max()) < 1e-4 * top, k
    assert pod_ck["step"] == one["step"] == 6


def test_pod_chunk_and_strata(pod):
    """Trap 3 (no collective inside a graph that cannot capture it): the
    ``process_shard`` strata are disjoint and cover the store; a gloo pod
    chunk (eager) equals its steps run one by one, bit for bit,
    with the counters equal on both ranks; ``train()`` through the pod
    cache runs its chunks with artifacts on rank 0 only."""
    _, ranks, _ = pod
    strata = [r["stratum"] for r in ranks]
    assert strata == [list(range(0, N_FILES, 2)), list(range(1, N_FILES, 2))]
    for r in ranks:
        (s_chunk, m_chunk), (s_step, m_step) = r["chunk"], r["per_step"]
        for a, b in zip(s_chunk, s_step):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for k, v in m_step.items():
            torch.testing.assert_close(m_chunk[k], v, rtol=0, atol=0)
    torch.testing.assert_close(ranks[0]["chunk"][0][-1], ranks[1]["chunk"][0][-1],
                               rtol=0, atol=0)
    assert ranks[0]["cache_steps"] == ranks[1]["cache_steps"] == 6
    assert "step6.pth" in ranks[0]["cache_files"] and ranks[1]["cache_files"] == []


def test_device_val_set_on_the_mesh(pod):
    """Each rank's resident validation set is the loader's batches on its
    card."""
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader

    root, ranks, _ = pod
    want = list(MemoryMappedActivationLoader(str(root / "store"), "L", 3))
    for r in ranks:
        assert [n for _, n, _ in r["val_set"]] == [3, 3, 2]
        for (x, _, files), (arr, names) in zip(r["val_set"], want):
            np.testing.assert_array_equal(x.numpy(), arr)
            assert list(files) == list(names)


def _read(folder: Path, layer: str):
    return ((folder / f"{layer}_metadata.json").read_text(),
            np.load(folder / f"{layer}_tensors.npy"))


@pytest.mark.parametrize("multi", [False, True], ids=["one_layer", "two_layers"])
def test_data_parallel_collection_merged(pod, multi, tmp_path, monkeypatch):
    """Each rank wrote ``shard<rank>`` (every 2nd file); the port's
    ``merge_stores`` restores one store whose metadata equals a one-rank
    collection's and JAX's merged shards', within 1e-6 of max of the
    one-rank store and 1e-4 of JAX's."""
    from freud_tpu.data.multilayer import collect_multilayer as jax_multilayer
    from freud_tpu.scripts import collect_activations as jcollect
    from freud_tpu.scripts.merge_stores import merge_shards as jax_merge
    from freud_tpu_torch.data.multilayer import collect_multilayer
    from freud_tpu_torch.scripts.collect_activations import get_activations
    from freud_tpu_torch.scripts.merge_stores import merge_shards

    root, _, _ = pod
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(root / "whisper"))
    layers = LAYERS if multi else [LAYER]
    dp = root / ("dpm" if multi else "dp")
    assert (dp / "shard0").is_dir() and (dp / "shard1").is_dir()
    common = dict(verbose=False)
    one, jdir = tmp_path / "one", tmp_path / "jax"
    if multi:
        collect_multilayer(str(root / "audio"), layers, "tiny", 2, str(one),
                           device="cpu", **common)
    else:
        get_activations(data_path=str(root / "audio"), layer_name=LAYER,
                        whisper_model="tiny", sae_model=None, batch_size=2,
                        out_folder=str(one), device="cpu", **common)
    # JAX's per-host shards, one process standing in for each host
    for i in range(2):
        monkeypatch.setattr(jcollect, "collection_shard_setup",
                            lambda out, dp_, i=i: (None, (i, 2), str(Path(out) / f"shard{i}")))
        if multi:
            jax_multilayer(str(root / "audio"), layers, "tiny", 2, str(jdir),
                           data_parallel=True, **common)
        else:
            jcollect.get_activations(data_path=str(root / "audio"), layer_name=LAYER,
                                     whisper_model="tiny", sae_model=None, batch_size=2,
                                     out_folder=str(jdir), data_parallel=True, **common)
    for layer in layers:
        merge_shards(str(dp), layer, verbose=False)
        jax_merge(str(jdir), layer, verbose=False)
        meta, got = _read(dp, layer)
        ometa, want = _read(one, layer)
        jmeta, jgot = _read(jdir, layer)
        assert meta == ometa == jmeta
        assert json.loads(meta)["filenames"] == sorted(
            str(p) for p in (root / "audio").glob("*.wav"))
        assert _max_rel(got, want) < 1e-6
        assert _max_rel(got, jgot) < 1e-4


def test_fly_loader_mesh_yields_the_whole_batch(pod, monkeypatch):
    """``FlyActivationLoader(mesh=)``: each rank encodes its half of every
    batch, and both yield the one-rank loader's batches (1e-6 of max)."""
    from freud_tpu_torch.data.loaders import FlyActivationLoader

    root, ranks, _ = pod
    monkeypatch.setenv("FREUD_WHISPER_DIR", str(root / "whisper"))
    want = list(FlyActivationLoader(str(root / "audio"), "tiny", None, LAYER, 2, device="cpu"))
    for r in ranks:
        assert [f for _, f in r["fly"]] == [list(f) for _, f in want]
        for (a, _), (b, _) in zip(r["fly"], want):
            assert a.shape == b.shape and _max_rel(a, b) < 1e-6


@pytest.mark.parametrize("where", ["scan", "fast"])
@pytest.mark.parametrize("kind", ["dense_f32", "indexed"])
def test_search_over_ranks_is_bit_equal(pod, kind, where):
    """Trap 6: ``top_activations(mesh=)`` on both ranks equals the one-rank
    search and JAX's, bit for bit (11 files at batch 3: uneven splits)."""
    from freud_tpu.analysis.search import top_activations as jax_top
    from freud_tpu.data.loaders import MemoryMappedActivationLoader as JaxLoader
    from freud_tpu_torch.analysis.search import top_activations
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader
    from tests.test_torch_search import _same

    root, ranks, _ = pod
    folder = str(root / f"search_{kind}_{where}")
    loader = MemoryMappedActivationLoader(folder, "encoder.blocks.2", batch_size=3)
    jloader = JaxLoader(folder, "encoder.blocks.2", batch_size=3)
    queries = [(f, q) for f in SEARCH_FEATS for q in SEARCH_QUERIES]
    for r in ranks:
        for got, (f, q) in zip(r[f"search_{kind}_{where}"], queries):
            _same(got, top_activations(loader, f, 4, device="cpu", **q))
            _same(got, jax_top(jloader, f, 4, **q))


def test_sweep_over_ranks(pod):
    """A two-member sweep step with ``mesh`` (each member's batch split over
    the ranks, its gradient all-reduced): within 1e-6 of max of the
    one-process sweep step and 1e-4 of JAX's sweep on a two-device mesh."""
    from freud_tpu_torch.models.sae import sweep_params_from_jax
    from freud_tpu_torch.train.sweep import SAESweepTrainer

    root, ranks, oracles = pod
    xs = global_batches()
    sw = SAESweepTrainer("topk", VARIANTS["topk"][1], D, 2, device="cpu",
                         **{**TRAINER_KW, "seed": 5})
    members = sweep_params_from_jax("topk", pickle.loads((root / "init_sweep.pkl").read_bytes()))
    with torch.no_grad():
        for m, src in zip(sw.members, members):
            for n, p in m.params.named_parameters():
                p.copy_(getattr(src, n))
    sw.train_step(np.stack([xs[0], xs[1]]))
    jax_members = sweep_params_from_jax("topk", oracles["jax_sweep"])
    for r in ranks:
        for got, m, jm in zip(r["sweep"], sw.members, jax_members):
            for a, b, n in zip(got, m._state(), ("encoder_weight", "encoder_bias",
                                                 "W_dec", "b_dec")):
                assert _max_rel(a, b) < 1e-6
                assert _max_rel(a, getattr(jm, n)) < 1e-4


def test_initialize_refuses_to_go_on_alone(capsys, monkeypatch):
    """A process told it is part of a pod (an address, two processes) whose
    start-up fails raises instead of training alone; with nothing saying
    pod, ``initialize`` says so and leaves no process group. Trap 4 (no
    backend switched on its own): NCCL on the CPU is refused, not swapped
    for gloo."""
    from freud_tpu_torch.parallel import distributed as dist_lib

    for k in ("MASTER_ADDR", "WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(Exception):
        dist_lib.initialize(f"127.0.0.1:{_free_port()}", 2, 1, device="cpu",
                            timeout_s=2)
    assert not torch.distributed.is_initialized()
    dist_lib.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert "single-process" in capsys.readouterr().out
    assert dist_lib.process_info() == {"process_index": 0, "process_count": 1,
                                       "local_devices": 1, "global_devices": 1}
    assert dist_lib.is_main_process()
    with pytest.raises(ValueError, match="nccl"):
        dist_lib.initialize("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")


def test_pod_input_keeps_one_order(tmp_path):
    """Trap 5 (every rank the same order): ``host_bounds`` needs
    ``drop_last``; the ranks' slices of each (seed, epoch) batch tile the
    one-process batch; ``train(mesh=)`` over several ranks refuses fly mode,
    as JAX's does."""
    from freud_tpu.data.store import ActivationStoreWriter
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader
    from freud_tpu_torch.parallel.mesh import Mesh
    from freud_tpu_torch.train.trainer import train

    w = ActivationStoreWriter(tmp_path / "s", "L", (T, D), (T, D))
    w.append_batch([f"f{i}" for i in range(N_FILES)],
                   np.random.default_rng(0).standard_normal((N_FILES, T, D)))
    w.close()
    with pytest.raises(ValueError, match="drop_last"):
        MemoryMappedActivationLoader(str(tmp_path / "s"), "L", 4, host_bounds=(0, 2))
    kw = dict(shuffle=True, drop_last=True, seed=5)
    whole = [b[0] for b in MemoryMappedActivationLoader(str(tmp_path / "s"), "L", 4, **kw)]
    parts = [[b[0] for b in MemoryMappedActivationLoader(
        str(tmp_path / "s"), "L", 4, host_bounds=bounds, **kw)] for bounds in ((0, 2), (2, 4))]
    assert len(whole) == 2
    for w_, a, b in zip(whole, *parts):
        np.testing.assert_array_equal(np.concatenate([a, b]), w_)
    mesh = Mesh("cpu")
    mesh.rank, mesh.world_size = 0, 2
    with pytest.raises(SystemExit, match="fly-mode"):
        train(**train_config(tmp_path, tmp_path / "run", from_disk=False, mesh=mesh,
                             start_checkpoint=None))


def test_mesh_helpers_split_like_jax():
    """``host_shard_bounds``, ``put_batch``'s slice and warn-once whole
    batch, ``pad_and_shard`` and ``make_mesh``'s device rules, on a mesh
    that stands for rank 1 of 2 (no process group needed). Trap 7 (the
    device comes from the caller): without a card, a rank asked for no
    device is refused, never placed on the CPU."""
    from freud_tpu_torch.parallel import mesh as mesh_lib

    m = mesh_lib.Mesh("cpu")
    assert m.shape == {"data": 1, "model": 1} and not mesh_lib.is_multiprocess(m)
    m.rank, m.world_size = 1, 2
    assert mesh_lib.is_multiprocess(m) and m.shape["data"] == 2
    assert mesh_lib.host_shard_bounds(6, m) == (3, 6)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.host_shard_bounds(5, m)
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(mesh_lib.put_batch(m, x).numpy(), x[3:])
    mesh_lib._warned_replicated = False
    with pytest.warns(UserWarning, match="WHOLE"):
        whole = mesh_lib.put_batch(m, x[:5])
    np.testing.assert_array_equal(whole.numpy(), x[:5])
    np.testing.assert_array_equal(mesh_lib.pad_and_shard(m, x[:3], 4).numpy(),
                                  np.concatenate([x[2:3], np.zeros((1, 2), np.float32)]))
    assert mesh_lib.make_mesh(device="cpu").size == 1
    assert mesh_lib.make_mesh(devices=["cpu"]).device == torch.device("cpu")
    with pytest.raises(ValueError, match="one device"):
        mesh_lib.make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="n_devices"):
        mesh_lib.make_mesh(n_devices=2, device="cpu")
    assert mesh_lib.local_mesh(m).size == 1
    assert mesh_lib.split_bounds(11, m) == (5, 11)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            mesh_lib.make_mesh()
