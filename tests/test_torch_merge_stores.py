"""freud_tpu_torch's ``merge_stores`` (a framework-free copy of the JAX
package's) on the JAX package's four cases (tests/test_merge_stores.py),
the port's ``AudioBatchPipeline(shard=)`` split, and each package merging
the shards the other wrote: the same bytes."""

import wave

import numpy as np
import pytest

from freud_tpu.data.store import ActivationStoreWriter as JaxWriter
from freud_tpu.scripts.merge_stores import merge_shards as jax_merge
from freud_tpu_torch.data.store import ActivationStoreReader, ActivationStoreWriter
from freud_tpu_torch.scripts import merge_stores
from freud_tpu_torch.scripts.merge_stores import merge_shards


def _write(folder, layer, names, data, n_frames, writer=ActivationStoreWriter):
    w = writer(folder, layer, data.shape[1:], data.shape[1:])
    w.append_batch(names, data, n_frames=n_frames)
    w.close()


def _shards(root, writer, n=11, t=6, f=4, p=3, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, t, f)).astype(np.float32)
    names = [f"/a/f{j:02d}.wav" for j in range(n)]
    frames = [int(x) for x in rng.integers(1, t + 1, n)]
    for i in range(p):
        _write(root / f"shard{i}", "L", names[i::p], data[i::p],
               [frames[j] for j in range(i, n, p)], writer)
    return data, names, frames


def test_merge_restores_original_order(tmp_path):
    """shard j%P row j//P → the merged store is the one-host collection of
    the same files (order, arrays, n_frames)."""
    data, names, frames = _shards(tmp_path, ActivationStoreWriter)
    stats = merge_shards(tmp_path, "L", chunk=4, verbose=False)
    assert stats == {"n_files": len(names), "shards": 3, "out_folder": tmp_path}
    r = ActivationStoreReader(tmp_path, "L")
    assert len(r) == len(names) and r.filenames == names
    assert [int(x) for x in r.n_frames] == frames
    got, got_names = r.batch(np.arange(len(names)))
    np.testing.assert_allclose(got, data)
    assert got_names == names


def test_pipeline_shard_param(tmp_path):
    """``AudioBatchPipeline(shard=(i, n))`` keeps exactly files[i::n] of the
    sorted universe, disjoint and exhaustive across shards."""
    from freud_tpu_torch.data.audio_dataset import AudioBatchPipeline

    for j in range(7):
        with wave.open(str(tmp_path / f"c{j}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(np.zeros(1600, np.int16).tobytes())
    full = AudioBatchPipeline(str(tmp_path), 2, 80).files
    assert len(full) == 7
    shards = [AudioBatchPipeline(str(tmp_path), 2, 80, shard=(i, 3)).files for i in range(3)]
    assert shards[0] == full[0::3]
    assert sorted(sum(shards, [])) == sorted(full)
    with pytest.raises(ValueError):
        AudioBatchPipeline(str(tmp_path), 2, 80, shard=(3, 3))


def test_merge_preserves_float16(tmp_path):
    """A float16 collection stays float16 through the merge."""
    rng = np.random.default_rng(0)
    n, p = 4, 2
    names = [f"f{i}.wav" for i in range(n)]
    data = rng.standard_normal((n, 3, 2)).astype(np.float16)
    for i in range(p):
        w = ActivationStoreWriter(tmp_path / f"shard{i}", "L", data.shape[1:],
                                  data.shape[1:], store_dtype=np.float16)
        w.append_batch(names[i::p], data[i::p], n_frames=np.full(len(names[i::p]), 3))
        w.close()
    merge_shards(tmp_path, "L", verbose=False)
    merged = np.load(tmp_path / "L_tensors.npy", mmap_mode="r")
    assert merged.dtype == np.float16
    r = ActivationStoreReader(tmp_path, "L")
    assert r.filenames == names
    for i in range(n):
        np.testing.assert_array_equal(np.asarray(r[i][0]), data[i].reshape(3, 2))


def test_merge_rejects_mixed_dtype_shards(tmp_path):
    """Ranks that collected with different store_dtype configs fail the
    merge loudly."""
    layer = "encoder.blocks.1"
    rng = np.random.default_rng(0)
    for i, dt in enumerate([np.float32, np.float16]):
        w = ActivationStoreWriter(tmp_path / f"shard{i}", layer, (4, 3), (4, 3),
                                  store_dtype=dt)
        w.append_batch([f"f{i}.wav"], rng.standard_normal((1, 4, 3)))
        w.close()
    with pytest.raises(ValueError, match="store_dtype"):
        merge_shards(str(tmp_path), layer, verbose=False)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_merges_the_others_shards(tmp_path, writer):
    """Shards written by either package merge to the same bytes in both,
    through the port's CLI too."""
    made = {"jax": JaxWriter, "torch": ActivationStoreWriter}[writer]
    for side in ("port", "jax"):
        _shards(tmp_path / side, made, seed=3)
    merge_stores.main(["--out_folder", str(tmp_path / "port"), "--layer_name", "L"])
    jax_merge(str(tmp_path / "jax"), "L", verbose=False)
    for suffix in ("_metadata.json", "_tensors.npy"):
        assert ((tmp_path / "port" / f"L{suffix}").read_bytes()
                == (tmp_path / "jax" / f"L{suffix}").read_bytes()), suffix
