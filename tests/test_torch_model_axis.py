"""freud_tpu_torch's model axis: ``make_mesh(model_parallel=P)`` and
``SAETrainer(shard_dict=True)``, with gloo ranks on the CPU.

The selection across dictionary shards (``ops/topk_sharded``) is held in
this process over simulated shards (P 2 and 4): its thresholds and fired
bits bit-equal to kernel #3 on the whole latent, JAX's kernel in interpret
mode and the port's plain version, on both routes (exact bf16; the float
bisection in f32, in signed bf16 and for n_dict ≥ 2¹⁵ split into shards
below it), with ties, silent rows, a shard without a dead latent and fewer
dead latents than k_aux.

One module fixture spawns two worlds once, in the style of
tests/test_torch_distributed.py: two ranks (a data 1 × model 2 mesh) and
four (data 2 × model 2). Each rank runs the sharded paths and saves what it
computed; meanwhile this process computes the oracles: the port's
one-process trainer on the same global batches and JAX's
``SAETrainer(shard_dict=True)`` on ``make_mesh(n_devices=2|4,
model_parallel=2)``, all started from one JAX initialisation
(``shard_params_from_jax``). Everything runs f32 with ``amp`` off, except
TopK and L1 stepped once more under ``amp`` against the replicated
dictionary on the same mesh. The bars:

* the sharded step (TopK with AuxK live, multi_topk, L1) against the
  one-process step: 1e-6 of max after 1 step, 1e-5 after 5, the counters
  equal; against JAX's sharded trainer: 1e-4 of max after 5 steps, the
  counters equal;
* under ``amp`` (kernel #4's encode and decode launches around the
  selection; L1's bf16 partial decode): TopK bit for bit, L1 within 1e-6
  of max after 1 and 5 steps;
* kernel #4's encode and decode launches over simulated shards against
  JAX's ``topk_sae_forward`` in interpret mode (``tests/test_torch_topk.py``'s
  bars);
* ``validate_files`` within 1e-6 of max of the one-process trainer's (the
  parameters already differ by summation order);
* checkpoints: a sharded save holds the gathered shards bit for bit and
  loads into the port unsharded and into JAX's sharded trainer; JAX's
  sharded save loads into the port sharded; a resume is bit-equal;
* a gloo pod chunk on the sharded trainer bit-equal to its steps;
* on the 2×2 mesh without ``shard_dict``: model peers own the same batch
  rows and draw the same cache indices, and the step is the one-process
  step (1e-6 / 1e-5 of max).
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
T, D, B, STEPS = 6, 8, 4, 5
TOPK = {"expansion_factor": 2, "k": 2, "auxk_alpha": 1 / 32, "dead_feature_threshold": 6}
VARIANTS = {
    "topk": ("topk", TOPK),
    "multi_topk": ("topk", {**TOPK, "multi_topk": True}),
    "l1": ("l1", {"n_dict_components": 16, "recon_alpha": 2.0}),
}
TRAINER_KW = dict(optimizer="adam", scheduler="linear",
                  scheduler_params={"num_warmup_steps": 1}, lr=1e-2, steps=12,
                  clip_thresh=1.0, seed=3, amp=False)
WORLDS = (2, 4)  # data 1 × model 2, data 2 × model 2
AMP_VARIANTS = ("topk", "l1")  # also stepped under amp (bf16 matmuls)
SEL_M, SEL_N, SEL_K, SEL_K_AUX, SEL_K_MULTI = 9, 32, 3, 5, 12
N_FILES = 8
WORKER_TIMEOUT_S = 240


def global_batches():
    return np.random.default_rng(11).standard_normal((STEPS, B, T, D)).astype(np.float32)


def selection_inputs():
    """A small post-ReLU latent with a silent row and a tie across the shard
    boundary, and a dead mask whose first shard holds no dead latent."""
    rng = np.random.default_rng(5)
    a = np.maximum(rng.standard_normal((SEL_M, SEL_N)), 0).astype(np.float32)
    a[1] = 0.0
    a[2, SEL_N // 2 - 3:SEL_N // 2 + 3] = 2.5
    dead = rng.random(SEL_N) < 0.4
    dead[: SEL_N // 4] = False
    return a, dead


def full_state(tr) -> list:
    """The whole dictionary's parameters, moments and counters (gathered over
    the model group when the trainer's dictionary is split)."""
    from freud_tpu_torch.train.trainer import _param_list

    params, leaves, counter = tr._full_state()
    return [*[t.detach().clone() for t in _param_list(tr.variant, params)],
            *[t.clone() for t in leaves[1:-1]], counter.clone()]


_WORKER = r'''
import pickle, sys
from pathlib import Path
rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from tests.test_torch_model_axis import (AMP_VARIANTS, B, D, SEL_K, SEL_K_AUX, SEL_K_MULTI,
                                         STEPS, TRAINER_KW, VARIANTS, full_state,
                                         global_batches, selection_inputs)
from freud_tpu_torch.parallel import distributed as dist_lib, mesh as mesh_lib

dist_lib.initialize(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)
out = {}
try:
    mesh_lib.make_mesh(model_parallel=3, device="cpu")
except ValueError as e:
    out["refusal"] = str(e)
mesh = mesh_lib.make_mesh(model_parallel=2, device="cpu")
out["layout"] = {
    "rank": mesh.rank, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
    "shape": mesh.shape, "size": mesh.size,
    "model_group": dist.get_process_group_ranks(mesh.model_group),
    "data_group": (None if mesh.data_group is None
                   else dist.get_process_group_ranks(mesh.data_group)),
}

# the model axis' collectives
bits = torch.tensor([rank, -1, 0x7FC00001, -2 ** 31], dtype=torch.int32)
out["gathered"] = mesh_lib.model_all_gather(mesh, bits)
t = torch.full((3,), float(rank + 1), requires_grad=True)
s = mesh_lib.model_sum(mesh, t * 2)
s.sum().backward()
out["sum"], out["sum_grad"] = s.detach(), t.grad.clone()
u = torch.ones(3, requires_grad=True)
(mesh_lib.model_copy(mesh, u) * (rank + 1)).sum().backward()
out["copy_grad"] = u.grad.clone()
out["reduced"] = mesh_lib.model_all_reduce(mesh, torch.tensor([float(rank)]), "max")

# the selection across real ranks
from freud_tpu_torch.ops.topk_sharded import sharded_thresholds_fired
a, dead = selection_inputs()
for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    acts = mesh_lib.shard_dict_slice(torch.from_numpy(a).to(dtype), 1, mesh)
    dm = mesh_lib.shard_dict_slice(torch.from_numpy(dead), 0, mesh)
    out[f"sel_{name}"] = sharded_thresholds_fired(acts, dm, SEL_K, SEL_K_AUX, mesh,
                                                  k_multi=SEL_K_MULTI)

from freud_tpu_torch.models.sae import shard_params_from_jax
from freud_tpu_torch.train.trainer import SAETrainer


def sharded(variant, cfg, init, amp=False):
    tr = SAETrainer(variant, cfg, D, mesh=mesh, shard_dict=True, **{**TRAINER_KW, "amp": amp})
    with torch.no_grad():
        for n, p in tr.params.named_parameters():
            p.copy_(getattr(shard_params_from_jax(variant, init, mesh), n))
    return tr


xs = global_batches()
for name, (variant, cfg) in VARIANTS.items():
    init = pickle.loads((root / f"init_{name}.pkl").read_bytes())
    tr = sharded(variant, cfg, init)
    rec = {"metrics": [], "counters": []}
    for i in range(STEPS):
        m = tr.train_step(xs[i])
        rec["metrics"].append({k: float(v) for k, v in m.items()})
        rec["counters"].append(full_state(tr)[-1])
        if i == 0:
            rec["state1"] = full_state(tr)
    rec["state5"] = full_state(tr)
    rec["val"] = tr.validate_files(xs[0], sae_out=True)
    path = root / f"w{world}_{name}.pth"
    tr.save(str(path), tr.hparams())
    dist_lib.barrier()
    # resume: a fresh sharded trainer from the file, one more step each
    tr2 = SAETrainer(variant, cfg, D, mesh=mesh, shard_dict=True, **TRAINER_KW)
    tr2.load(str(path))
    rec["loaded"] = full_state(tr2)
    tr.train_step(xs[0])
    tr2.train_step(xs[0])
    rec["resumed"] = (full_state(tr2), full_state(tr))
    out[name] = rec

# under amp: kernel #4's encode and decode launches (TopK), the bf16 partial
# decode (L1)
# decode (L1); against the same steps with the dictionary replicated over
# the data axis of the same mesh
from freud_tpu_torch.models.sae import params_from_jax
for name in AMP_VARIANTS:
    variant, cfg = VARIANTS[name]
    init = pickle.loads((root / f"init_{name}.pkl").read_bytes())
    replicated = SAETrainer(variant, cfg, D, mesh=mesh, **{**TRAINER_KW, "amp": True})
    with torch.no_grad():
        for n, p in replicated.params.named_parameters():
            p.copy_(getattr(params_from_jax(variant, init), n))
    rec = {}
    for key, tr in (("sharded", sharded(variant, cfg, init, amp=True)),
                    ("replicated", replicated)):
        run = rec[key] = {"metrics": []}
        for i in range(STEPS):
            run["metrics"].append({k: float(v) for k, v in tr.train_step(xs[i]).items()})
            if i == 0:
                run["state1"] = full_state(tr)
        run["state5"] = full_state(tr)
    out[f"{name}_amp"] = rec

# JAX's sharded checkpoint into the port's sharded trainer
tr = SAETrainer("topk", VARIANTS["topk"][1], D, mesh=mesh, shard_dict=True, **TRAINER_KW)
tr.load(str(root / "jax_topk.pth"))
out["jax_loaded"] = (full_state(tr), [t.clone() for t in tr.params.parameters()])

# the pod chunk (eager under gloo) against its steps, on a process_shard cache
from freud_tpu_torch.data.device_cache import DeviceShuffleCache, sample_rows
caches = [DeviceShuffleCache(str(root / "store"), "L", 8, refresh_files=0, seed=7,
                             process_shard=(mesh.data_rank, mesh.data_size), device="cpu")
          for _ in range(2)]
local = B // mesh.data_size
idx = caches[0].draw(STEPS, local)
out["draw"] = idx.clone()
init = pickle.loads((root / "init_topk.pkl").read_bytes())
runs = []
for chunked, cache in zip((True, False), caches):
    tr = sharded("topk", VARIANTS["topk"][1], init)
    if chunked:
        ms = tr.train_chunk_pod(cache, local, STEPS, indices=idx)
        last = {k: v[-1] for k, v in ms.items()}
    else:
        for i in range(STEPS):
            last = tr.train_step(sample_rows(cache.cache, idx[i]), host_local=True)
    runs.append((full_state(tr), last))
out["chunk"], out["per_step"] = runs

# without shard_dict: a replicated dictionary over the data axis
out["bounds"] = mesh_lib.host_shard_bounds(B, mesh)
tr = SAETrainer("topk", VARIANTS["topk"][1], D, mesh=mesh, **TRAINER_KW)
with torch.no_grad():
    from freud_tpu_torch.models.sae import params_from_jax
    for n, p in tr.params.named_parameters():
        p.copy_(getattr(params_from_jax("topk", init), n))
for i in range(STEPS):
    tr.train_step(xs[i])
    if i == 0:
        out["replicated1"] = full_state(tr)
out["replicated5"] = full_state(tr)

dist_lib.barrier()
(root / f"w{world}_rank{rank}.pkl").write_bytes(pickle.dumps(out))
dist_lib.shutdown()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_tree(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _jax_trainer(variant, cfg, world):
    from freud_tpu.parallel import mesh as jmesh_lib
    from freud_tpu.train.trainer import SAETrainer as JaxTrainer

    return JaxTrainer(variant, cfg, D, mesh=jmesh_lib.make_mesh(n_devices=world,
                                                               model_parallel=2),
                      shard_dict=True, **TRAINER_KW)


def _port_trainer(variant, cfg, init):
    from freud_tpu_torch.models.sae import params_from_jax
    from freud_tpu_torch.train.trainer import SAETrainer

    tr = SAETrainer(variant, cfg, D, device="cpu", **TRAINER_KW)
    with torch.no_grad():
        for n, p in tr.params.named_parameters():
            p.copy_(getattr(params_from_jax(variant, init), n))
    return tr


def _prepare(root: Path) -> dict:
    """JAX's sharded trainers (their initial parameters for both packages),
    JAX's one-step sharded checkpoint and a store for the caches."""
    from freud_tpu.data.store import ActivationStoreWriter

    jtrainers = {}
    for world in WORLDS:
        for name, (variant, cfg) in VARIANTS.items():
            jtrainers[world, name] = _jax_trainer(variant, cfg, world)
    for name in VARIANTS:
        (root / f"init_{name}.pkl").write_bytes(
            pickle.dumps(_np_tree(jtrainers[2, name].params)))
    jt = _jax_trainer("topk", TOPK, 2)
    jt.train_step(global_batches()[0])
    jt.save(str(root / "jax_topk.pth"), jt.hparams())
    w = ActivationStoreWriter(root / "store", "L", (T, D), (T, D))
    w.append_batch([f"f{i}" for i in range(N_FILES)],
                   np.random.default_rng(0).standard_normal((N_FILES, T, D)).astype(np.float32))
    w.close()
    return jtrainers


def _oracles(root: Path, jtrainers: dict) -> dict:
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
            if i == 0:
                rec["state1"] = full_state(tr)
        rec["state5"] = full_state(tr)
        rec["val"] = tr.validate_files(xs[0], sae_out=True)
        out[name] = rec
        for world in WORLDS:
            jt = jtrainers[world, name]
            for i in range(STEPS):
                jt.train_step(xs[i])
            out[world, name] = (_np_tree(jt.params), np.asarray(jt.num_frames_since_fired))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Spawn both worlds, compute the oracles meanwhile, collect every
    rank."""
    root = tmp_path_factory.mktemp("model_axis")
    t0 = time.perf_counter()
    jtrainers = _prepare(root)
    worker = root / "worker.py"
    worker.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for world in WORLDS:
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, str(worker), str(r), str(world),
                                    str(port), str(root), str(REPO)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True, env=env) for r in range(world)]
    try:
        oracles = _oracles(root, jtrainers)
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{o}"
    ranks = {w: [pickle.loads((root / f"w{w}_rank{r}.pkl").read_bytes()) for r in range(w)]
             for w in WORLDS}
    print(f"two worlds and the oracles in {time.perf_counter() - t0:.1f} s")
    return root, ranks, oracles


def _max_rel(a, b) -> float:
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _fields(variant):
    return (("W", "encoder_bias") if variant == "l1"
            else ("encoder_weight", "encoder_bias", "W_dec", "b_dec"))


def _same(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------- the selection, one process


def _simulate(acts, dead, k, k_aux, k_multi, p, n_dict=None, signed=False):
    """Every shard's candidates, stacked as the model group's gather would,
    then each shard's combine: → [(t_main, t_aux, t_multi, fired_s)] a
    shard."""
    from freud_tpu_torch.ops.topk_sharded import (combine_shard_thresholds, key_kind,
                                                  shard_candidates)

    n = acts.shape[1]
    n_dict = n if n_dict is None else n_dict
    s = n // p
    kind = key_kind(acts, n_dict, signed)
    cands = torch.stack([shard_candidates(acts[:, i * s:(i + 1) * s], dead[i * s:(i + 1) * s],
                                          max(k, k_multi), k_aux, kind) for i in range(p)])
    return [combine_shard_thresholds(cands, acts[:, i * s:(i + 1) * s], n_dict, k, k_aux,
                                     k_multi, kind) for i in range(p)]


def _selection_case(dead_kind, p):
    """test_torch_topk's latent (silent rows, ties, few positives) and dead
    masks, plus a mask whose first shard holds no dead latent."""
    from tests.test_torch_topk import K, K_AUX, K_MULTI, N, _acts, _dead

    a = _acts()
    if dead_kind == "first_shard_alive":
        dead = _dead("many")
        dead[: N // p] = False
    else:
        dead = _dead(dead_kind)
    return a, dead, K, K_AUX, K_MULTI


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dead_kind", ["many", "few", "none", "first_shard_alive"])
@pytest.mark.parametrize("route", ["bf16_exact", "f32", "bf16_signed"])
def test_selection_across_shards_bit_equal(route, dead_kind, p):
    """The two launches' plain versions over P simulated shards give kernel
    #3's thresholds on the whole latent (JAX's Pallas kernel in interpret
    mode, and the port's plain version) bit for bit, and each shard's fired
    bits are its columns of the whole fired mask."""
    import jax.numpy as jnp

    from freud_tpu.ops.topk_threshold import topk_thresholds_fired as jax_thresholds
    from freud_tpu_torch.ops.topk_sharded import combine_shard_thresholds, shard_candidates
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired_plain

    a, dead, k, k_aux, k_multi = _selection_case(dead_kind, p)
    signed = route == "bf16_signed"
    if signed:
        a = a - 0.5
    jdt = jnp.float32 if route == "f32" else jnp.bfloat16
    ja = jnp.asarray(a).astype(jdt)
    want = jax_thresholds(ja, jnp.asarray(dead), k, k_aux, interpret=True, k_multi=k_multi,
                          signed=signed)
    ta = torch.from_numpy(np.array(ja.astype(jnp.float32)))
    ta = ta if route == "f32" else ta.to(torch.bfloat16)
    td = torch.from_numpy(dead)
    plain = topk_thresholds_fired_plain(ta, td, k, k_aux, k_multi=k_multi, signed=signed)
    before = (shard_candidates.launches, combine_shard_thresholds.launches)
    got = _simulate(ta, td, k, k_aux, k_multi, p, signed=signed)
    assert (shard_candidates.launches, combine_shard_thresholds.launches) == before
    s = a.shape[1] // p
    for i, (t_main, t_aux, t_multi, fired) in enumerate(got):
        for g, w, pl in zip((t_main, t_aux, t_multi), want[:3], plain[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            _same(g, pl)
        np.testing.assert_array_equal(fired.numpy(), np.asarray(want[3])[i * s:(i + 1) * s])
    if dead_kind == "none":
        assert np.isinf(got[0][1].numpy()).all()


@pytest.mark.parametrize("p", [2, 4])
def test_selection_routes_by_the_global_width(p):
    """Trap (ii): a bf16 dictionary of 2¹⁵ columns takes the float path even
    though each shard is narrower than 2¹⁵ (where the exact path would
    give another threshold); bit-equal to the whole latent's."""
    from freud_tpu_torch.ops.topk_sharded import BF16, EXACT, key_kind
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired_plain

    rng = np.random.default_rng(3)
    n = 2 ** 15
    a = torch.from_numpy(np.maximum(rng.standard_normal((4, n)), 0).astype(np.float32))
    a = a.to(torch.bfloat16)
    dead = torch.from_numpy(rng.random(n) < 0.01)
    want = topk_thresholds_fired_plain(a, dead, 32, 64, k_multi=128)
    got = _simulate(a, dead, 32, 64, 128, p)
    s = n // p
    for i, (t_main, t_aux, t_multi, fired) in enumerate(got):
        _same(t_main, want[0])
        _same(t_aux, want[1])
        _same(t_multi, want[2])
        _same(fired, want[3][i * s:(i + 1) * s])
    # the shard's own width would pick the exact path
    assert key_kind(a[:, :s], s) == EXACT and key_kind(a[:, :s], n) == BF16


def test_candidates_carry_the_whole_row_range():
    """Trap (i): the float path's bisection starts from the row's finite min
    and max; the candidates' header carries them, and a threshold replayed
    from the candidates' own range would differ."""
    from freud_tpu_torch.ops.topk_sharded import (F32, HEADER, shard_candidates,
                                                  values_of)
    from freud_tpu_torch.ops.topk_threshold import replay_kth

    a, dead = selection_inputs()
    ta = torch.from_numpy(a)
    s = SEL_N // 2
    cand = shard_candidates(ta[:, :s], torch.from_numpy(dead[:s]), SEL_K, SEL_K_AUX, F32)
    assert cand.shape == (SEL_M, SEL_K + SEL_K_AUX + HEADER)
    keys = cand.to(torch.int64) & 0xFFFFFFFF
    header = keys[:, -HEADER:]
    shard = ta[:, :s]
    _same(values_of(header[:, 1], F32), shard.amax(dim=-1))
    _same(values_of(header[:, 0], F32), shard.amin(dim=-1))
    assert (header[:, 4] == int(dead[:s].sum())).all()
    whole = replay_kth(ta, SEL_K)
    from_cands = replay_kth(values_of(keys[:, :SEL_K], F32), SEL_K)
    assert not torch.equal(whole, from_cands)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dead_kind", ["many", "few", "none"])
def test_kernel4_launches_across_shards_match_jax_kernel(dead_kind, p):
    """The sharded bf16 step's forward in one process over P simulated
    shards: kernel #4's encode launch on each shard's dictionary rows, the
    selection across the shards, kernel #4's decode launch on each shard,
    the partial decodes summed; against JAX's ``topk_sae_forward`` on the
    whole dictionary in interpret mode at ``tests/test_torch_topk.py``'s
    bars (acts within 1 bf16 ulp on fewer than 1e-3 of entries, thresholds
    equal on rows whose acts are, decodes within 2e-2 of max), and the
    plain versions compose to the port's whole forward bit for bit."""
    import jax.numpy as jnp

    from freud_tpu.ops.topk_fused import topk_sae_forward as jax_fused
    from freud_tpu_torch.ops.topk_fused import (topk_sae_decode, topk_sae_encode,
                                                topk_sae_forward_plain)
    from tests.test_torch_topk import K, K_AUX, N, _dead, _fused_inputs

    x, w_enc, b_enc, b_dec, w_dec = _fused_inputs()
    dead_f = _dead(dead_kind).astype(np.float32)
    want = jax_fused(jnp.asarray(x), jnp.asarray(w_enc.T), jnp.asarray(b_enc),
                     jnp.asarray(b_dec), jnp.asarray(w_dec), jnp.asarray(dead_f),
                     K, K_AUX, interpret=True)
    tx, tw, tb, tbd, twd, td = (torch.from_numpy(v) for v in
                                (x, w_enc, b_enc, b_dec, w_dec, dead_f))
    s = N // p
    cols = [slice(i * s, (i + 1) * s) for i in range(p)]
    before = (topk_sae_encode.launches, topk_sae_decode.launches)
    acts_s = [topk_sae_encode(tx, tw[c].T, tb[c], tbd) for c in cols]
    sel = _simulate(torch.cat(acts_s, dim=1), td > 0, K, K_AUX, 0, p)
    parts = [topk_sae_decode(a, twd[c], td[c], t_main, t_aux)
             for a, c, (t_main, t_aux, _, _) in zip(acts_s, cols, sel)]
    assert (topk_sae_encode.launches, topk_sae_decode.launches) == before  # CPU: plain
    y = [sum(part[i] for part in parts) for i in (0, 1)]
    acts = torch.cat(acts_s, dim=1)
    whole = topk_sae_forward_plain(tx, tw.T, tb, tbd, twd, td, K, K_AUX)
    _same(acts, whole[0])
    for t_main, t_aux, _, fired in sel:
        _same(t_main, whole[3])
        _same(t_aux, whole[4])
    _same(torch.cat([f for *_, f in sel]), whole[5])
    acts_j = np.asarray(want[0].astype(jnp.float32))
    differ = acts_j != acts.float().numpy()
    assert differ.mean() < 1e-3
    if differ.any():  # one bf16 ulp at most
        ulp = np.abs(acts_j[differ]) * 2.0 ** -7
        assert (np.abs(acts_j - acts.float().numpy())[differ] <= ulp).all()
    same_rows = ~differ.any(axis=1)
    np.testing.assert_array_equal(sel[0][0].numpy()[same_rows], np.asarray(want[3])[same_rows])
    np.testing.assert_array_equal(sel[0][1].numpy()[same_rows], np.asarray(want[4])[same_rows])
    for got, ref in zip(y, want[1:3]):  # decodes, b_dec excluded
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() / max(np.abs(ref).max(), 1e-30) < 2e-2


# ------------------------------------------------------------------ the ranks


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_layout_is_jax_layout(worlds, world):
    """Rank r at data index r // P and model index r % P; the model groups
    are consecutive ranks, the data groups strided; ``size`` stays the
    world; a world that P does not divide is refused, as JAX refuses it."""
    _, ranks, _ = worlds
    for r, out in enumerate(ranks[world]):
        lay = out["layout"]
        assert (lay["rank"], lay["data_rank"], lay["model_rank"]) == (r, r // 2, r % 2)
        assert lay["shape"] == {"data": world // 2, "model": 2} and lay["size"] == world
        assert lay["model_group"] == [r - r % 2, r - r % 2 + 1]
        assert lay["data_group"] == (None if world == 2 else [r % 2, r % 2 + 2])
        assert "not divisible by model_parallel=3" in out["refusal"]


def test_make_mesh_refuses_a_world_p_does_not_divide():
    """JAX's ``make_mesh`` refusal (tests/test_infra.py): one process is a
    world of one rank."""
    from freud_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        make_mesh(model_parallel=2, device="cpu")
    mesh = make_mesh(model_parallel=1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model_group is None


@pytest.mark.parametrize("world", WORLDS)
def test_model_collectives(worlds, world):
    """``model_all_gather`` is bit-exact (NaN payloads and -0.0 included) and
    in model-rank order; ``model_sum`` sums forward and passes the gradient
    through; ``model_copy`` sums the gradient; reductions stay inside the
    model group."""
    _, ranks, _ = worlds
    for r, out in enumerate(ranks[world]):
        base = r - r % 2
        want = torch.tensor([[base, -1, 0x7FC00001, -2 ** 31],
                             [base + 1, -1, 0x7FC00001, -2 ** 31]], dtype=torch.int32)
        _same(out["gathered"], want)
        _same(out["sum"], torch.full((3,), 2.0 * (2 * base + 3)))
        _same(out["sum_grad"], torch.full((3,), 2.0))
        _same(out["copy_grad"], torch.full((3,), float(2 * base + 3)))
        _same(out["reduced"], torch.tensor([float(base + 1)]))


@pytest.mark.parametrize("world", WORLDS)
def test_selection_across_ranks(worlds, world):
    """The selection with its gather over real ranks: every model rank holds
    the whole latent's thresholds, and its columns of the fired mask."""
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired_plain

    _, ranks, _ = worlds
    a, dead = selection_inputs()
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        want = topk_thresholds_fired_plain(torch.from_numpy(a).to(dtype),
                                           torch.from_numpy(dead), SEL_K, SEL_K_AUX,
                                           k_multi=SEL_K_MULTI)
        for r, out in enumerate(ranks[world]):
            t_main, t_aux, t_multi, fired = out[f"sel_{name}"]
            _same(t_main, want[0])
            _same(t_aux, want[1])
            _same(t_multi, want[2])
            s = SEL_N // 2
            _same(fired, want[3][(r % 2) * s:(r % 2 + 1) * s])


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_one_process(worlds, world, name):
    """The gathered parameters and moments within 1e-6 of max after one
    step and 1e-5 after five, the counters equal after every step, the
    logged metrics the one-process ones."""
    _, ranks, oracles = worlds
    want = oracles[name]
    for out in ranks[world]:
        got = out[name]
        for a, b in zip(got["state1"][:-1], want["state1"][:-1]):
            assert _max_rel(a, b) < 1e-6
        for a, b in zip(got["state5"][:-1], want["state5"][:-1]):
            assert _max_rel(a, b) < 1e-5
        for c_got, c_want in zip(got["counters"], want["counters"]):
            _same(c_got, c_want)
        for m_got, m_want in zip(got["metrics"], want["metrics"]):
            for k, v in m_want.items():
                assert m_got[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    if VARIANTS[name][0] == "topk":
        assert max(m["auxk_loss"] for m in want["metrics"][1:]) > 0, "AuxK never ran"


@pytest.mark.parametrize("name", AMP_VARIANTS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_amp_step_matches_replicated(worlds, world, name):
    """Under ``amp`` (bf16 matmuls: kernel #4's encode and decode launches
    around the selection for TopK, the bf16 partial decode for L1) the
    sharded step against the same steps with the dictionary replicated over
    the same mesh's data axis: TopK bit for bit, L1 within 1e-6 of max
    after 1 step and after 5 (the partial decodes sum in another order), the
    counters and logged metrics equal."""
    _, ranks, _ = worlds
    for out in ranks[world]:
        got, want = out[f"{name}_amp"]["sharded"], out[f"{name}_amp"]["replicated"]
        bar = 0.0 if name == "topk" else 1e-6
        for key in ("state1", "state5"):
            for a, b in zip(got[key][:-1], want[key][:-1]):
                assert _max_rel(a, b) <= bar, key
            _same(got[key][-1], want[key][-1])
        for m_got, m_want in zip(got["metrics"], want["metrics"]):
            for k, v in m_want.items():
                assert m_got[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_jax_shard_dict(worlds, world, name):
    """Against JAX's ``SAETrainer(shard_dict=True)`` on
    ``make_mesh(n_devices=world, model_parallel=2)``: 1e-4 of max after
    five steps, the counters equal."""
    _, ranks, oracles = worlds
    jparams, jcounters = oracles[world, name]
    for out in ranks[world]:
        state = out[name]["state5"]
        for i, field in enumerate(_fields(VARIANTS[name][0])):
            assert _max_rel(state[i], jparams[field]) < 1e-4
        np.testing.assert_array_equal(state[-1].numpy(), jcounters)


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("world", WORLDS)
def test_validate_files_matches_one_process(worlds, world, name):
    """``validate_files`` on the split dictionary: every statistic, the
    per-feature magnitudes over the whole dictionary and the
    reconstructions within 1e-6 of max of the one-process trainer's."""
    _, ranks, oracles = worlds
    want = oracles[name]["val"]
    for out in ranks[world]:
        got = out[name]["val"]
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape == v.shape, k
            assert _max_rel(got[k], v) < 1e-6, k


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_checkpoint_is_the_whole_dictionary(worlds, world, name):
    """A sharded save holds the gathered shards bit for bit under the
    unsharded keys and shapes, and loads into an unsharded port trainer
    as exactly that state."""
    from freud_tpu_torch.train.trainer import SAETrainer

    root, ranks, _ = worlds
    variant, cfg = VARIANTS[name]
    path = root / f"w{world}_{name}.pth"
    ck = torch.load(path, weights_only=True)
    state = ranks[world][0][name]["state5"]
    n_params = len(_fields(variant))
    keys = (("decoder.weight", "encoder_bias") if variant == "l1"
            else ("encoder.weight", "encoder.bias", "W_dec", "b_dec"))
    for k, t in zip(keys, state[:n_params]):
        _same(ck["model"][k], t)
    for leaf, t in zip(ck["optimizer"]["leaves"][1:-1], state[n_params:-1]):
        _same(leaf, t)
    _same(ck["num_frames_since_fired"], state[-1])
    one = SAETrainer(variant, cfg, D, device="cpu", **TRAINER_KW)
    one.load(str(path))
    for a, b in zip(full_state(one), state):
        _same(a, b)
    for out in ranks[world]:
        for a, b in zip(out[name]["loaded"], state):
            _same(a, b)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_port_sharded_checkpoint_loads_into_jax(worlds, name):
    """JAX's sharded trainer reads the port's sharded checkpoint: the same
    parameters and counters, bit for bit."""
    root, ranks, _ = worlds
    variant, cfg = VARIANTS[name]
    jt = _jax_trainer(variant, cfg, 2)
    jt.load(str(root / f"w2_{name}.pth"))
    state = ranks[2][0][name]["state5"]
    for i, field in enumerate(_fields(variant)):
        np.testing.assert_array_equal(np.asarray(getattr(jt.params, field)), state[i].numpy())
    np.testing.assert_array_equal(np.asarray(jt.num_frames_since_fired), state[-1].numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_jax_sharded_checkpoint_loads_sharded(worlds, world):
    """JAX's sharded save loads into the port's sharded trainer: each rank
    holds its rows of it, and the gathered state is the file's."""
    root, ranks, _ = worlds
    ck = torch.load(root / "jax_topk.pth", weights_only=True)
    keys = ("encoder.weight", "encoder.bias", "W_dec", "b_dec")
    n_dict = ck["model"]["W_dec"].shape[0]
    for r, out in enumerate(ranks[world]):
        state, local = out["jax_loaded"]
        for k, t in zip(keys, state[:4]):
            _same(t, ck["model"][k])
        for leaf, t in zip(ck["optimizer"]["leaves"][1:-1], state[4:-1]):
            _same(t, leaf)
        _same(state[-1], ck["num_frames_since_fired"])
        lo = (r % 2) * n_dict // 2
        _same(local[0], ck["model"]["encoder.weight"][lo:lo + n_dict // 2])
        _same(local[3], ck["model"]["b_dec"])


@pytest.mark.parametrize("world", WORLDS)
def test_resume_is_bit_equal(worlds, world):
    """A sharded trainer resumed from the sharded checkpoint steps exactly as
    the trainer that wrote it."""
    _, ranks, _ = worlds
    for out in ranks[world]:
        for name in VARIANTS:
            resumed, going = out[name]["resumed"]
            for a, b in zip(resumed, going):
                _same(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pod_chunk_equals_its_steps(worlds, world):
    """A gloo pod chunk (eager: gloo's collectives cannot be captured) on a
    split dictionary equals its steps run one by one, bit for bit; model
    peers draw the same cache indices, data ranks their own."""
    _, ranks, _ = worlds
    rs = ranks[world]
    for out in rs:
        (s_chunk, m_chunk), (s_step, m_step) = out["chunk"], out["per_step"]
        for a, b in zip(s_chunk, s_step):
            _same(a, b)
        for k, v in m_step.items():
            _same(m_chunk[k], v)
    for r in range(0, world, 2):
        _same(rs[r]["draw"], rs[r + 1]["draw"])
        _same(rs[r]["chunk"][0][0], rs[0]["chunk"][0][0])
    if world == 4:
        assert not torch.equal(rs[0]["draw"], rs[2]["draw"])


def test_replicated_dictionary_on_the_2x2_mesh(worlds):
    """Without ``shard_dict`` a 2×2 mesh trains a replicated dictionary over
    the data axis: model peers own the same batch rows, and the step is the
    one-process step (1e-6 of max after one step, 1e-5 after five), equal
    on every rank."""
    _, ranks, oracles = worlds
    rs = ranks[4]
    assert [r["bounds"] for r in rs] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    want = oracles["topk"]
    for out in rs:
        for a, b in zip(out["replicated1"], want["state1"]):
            assert _max_rel(a, b) < 1e-6
        for a, b in zip(out["replicated5"], want["state5"]):
            assert _max_rel(a, b) < 1e-5
        for a, b in zip(out["replicated5"], rs[0]["replicated5"]):
            _same(a, b)


# ------------------------------------------------------------- one process


@pytest.mark.parametrize("name", list(VARIANTS))
def test_shard_dict_of_one_rank_is_the_unsharded_trainer(name):
    """``shard_dict`` on a model axis of one rank changes nothing: the same
    parameters from the seed, the same steps, bit for bit, and a
    checkpoint of the same tensors."""
    from freud_tpu_torch.parallel.mesh import Mesh
    from freud_tpu_torch.train.trainer import SAETrainer

    variant, cfg = VARIANTS[name]
    xs = global_batches()
    a = SAETrainer(variant, cfg, D, device="cpu", **TRAINER_KW)
    b = SAETrainer(variant, cfg, D, mesh=Mesh("cpu"), shard_dict=True, **TRAINER_KW)
    for i in range(2):
        a.train_step(xs[i])
        b.train_step(xs[i])
    for x, y in zip(full_state(a), full_state(b)):
        _same(x, y)


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``SAETrainer``, ``DeviceShuffleCache`` and ``FlyActivationLoader``
    given neither a device nor a mesh resolve the card; without CUDA they
    raise with the hint to pass ``device="cpu"``, and never carry on on the
    CPU."""
    from freud_tpu.data.store import ActivationStoreWriter
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache
    from freud_tpu_torch.data.loaders import FlyActivationLoader
    from freud_tpu_torch.train.trainer import SAETrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = ActivationStoreWriter(tmp_path / "s", "L", (T, D), (T, D))
    w.append_batch(["a", "b"], np.zeros((2, T, D), np.float32))
    w.close()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SAETrainer("topk", TOPK, D, **TRAINER_KW)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DeviceShuffleCache(str(tmp_path / "s"), "L", 2, refresh_files=0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FlyActivationLoader(str(tmp_path), "tiny", None, "encoder.blocks.1", 2)
