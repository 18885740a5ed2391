"""The feature-major index in both packages: freud_tpu_torch's
``data/feature_store.py`` against freud_tpu's on three seeded stores
(dense f32, dense f16 and indexed, i.e. a TopK store's (T, k) pairs).

Held: the index files and the meta JSON either package builds and extends
are byte-identical; a same-size re-collection invalidates the index in
both; each package's readers read the other's index; and the port's
search fast path equals its scan and JAX's fast path exactly (the plane's
values are the store's, so the maxima and their frames are exact)."""

import shutil

import numpy as np
import pytest

from freud_tpu.analysis.search import top_activations as jax_top
from freud_tpu.data import feature_store as jfs
from freud_tpu.data.loaders import MemoryMappedActivationLoader as JaxLoader
from freud_tpu_torch.analysis.search import top_activations
from freud_tpu_torch.data import feature_store as tfs
from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader
from freud_tpu_torch.data.store import ActivationStoreWriter

LAYER = "encoder.blocks.2"
T, F, K, N_DICT = 40, 12, 4, 24
KINDS = ["dense_f32", "dense_f16", "indexed"]


def write_store(folder, kind: str, n_files: int, seed: int, prefix: str = "f",
                overwrite: bool = True) -> None:
    """``n_files`` seeded files in two appends (a ragged second one), with
    n_frames from 0 up to T; an indexed store's rows hold K distinct
    feature ids each (TopK never repeats one in a row)."""
    rng = np.random.default_rng(seed)
    names = [f"/data/{prefix}{i}.wav" for i in range(n_files)]
    n_frames = [int(v) for v in rng.integers(0, T + 1, n_files)]
    if n_files > 2:
        n_frames[1] = 0
    indexed = kind == "indexed"
    w = ActivationStoreWriter(
        folder, LAYER, tensor_shape=(T, K if indexed else F),
        activation_shape=(T, N_DICT if indexed else F), indexed=indexed,
        overwrite=overwrite,
        store_dtype=np.float16 if kind == "dense_f16" else np.float32)
    cut = (n_files + 1) // 2
    for lo, hi in ((0, cut), (cut, n_files)):
        m = hi - lo
        if indexed:
            vals = rng.uniform(0, 3, (m, T, K)).astype(np.float32)
            idx = np.argsort(rng.random((m, T, N_DICT)), axis=-1)[..., :K].astype(np.int64)
            w.append_batch(names[lo:hi], vals, idx, n_frames=n_frames[lo:hi])
        else:
            acts = rng.uniform(-2, 2, (m, T, F)).astype(np.float32)
            w.append_batch(names[lo:hi], acts, n_frames=n_frames[lo:hi])
        w.flush()
    w.close()


def index_files(folder) -> dict:
    return {p.name: p.read_bytes() for p in sorted(folder.iterdir())
            if "feature_major" in p.name}


def build(fs, folder, kind):
    if kind == "indexed":
        return fs.build_sparse_feature_major_index(folder, LAYER, chunk_files=3,
                                                   verbose=False)
    return fs.build_feature_major_index(folder, LAYER, chunk_files=3, verbose=False)


def extend(fs, folder, kind):
    if kind == "indexed":
        return fs.extend_sparse_feature_major_index(folder, LAYER, chunk_files=3,
                                                    verbose=False)
    return fs.extend_feature_major_index(folder, LAYER, chunk_files=3, verbose=False)


def reader(fs, folder, kind, subset=None):
    cls = fs.SparseFeatureMajorReader if kind == "indexed" else fs.FeatureMajorReader
    return cls(folder, LAYER, subset_size=subset)


def is_current(fs, folder, kind, n):
    check = fs.sparse_index_is_current if kind == "indexed" else fs.index_is_current
    return check(folder, LAYER, n)


def twin_stores(tmp_path, kind, n_files=7, seed=0):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    write_store(jdir, kind, n_files, seed)
    shutil.copytree(jdir, tdir)
    return jdir, tdir


@pytest.mark.parametrize("kind", KINDS)
def test_build_and_extend_are_byte_identical(tmp_path, kind):
    jdir, tdir = twin_stores(tmp_path, kind)
    build(jfs, jdir, kind)
    build(tfs, tdir, kind)
    first = index_files(jdir)
    assert first and index_files(tdir) == first
    # the store grows by 5 files: each package appends one segment
    for d in (jdir, tdir):
        write_store(d, kind, 5, seed=9, prefix="g", overwrite=False)
    assert not is_current(tfs, tdir, kind, 12) and not is_current(jfs, jdir, kind, 12)
    extend(jfs, jdir, kind)
    extend(tfs, tdir, kind)
    grown = index_files(jdir)
    assert len(grown) == len(first) + (1 if kind != "indexed" else 5)
    assert index_files(tdir) == grown
    assert is_current(tfs, tdir, kind, 12) and is_current(jfs, jdir, kind, 12)
    # a current index extends to nothing
    assert extend(tfs, tdir, kind) is None and extend(jfs, jdir, kind) is None
    assert index_files(tdir) == grown


@pytest.mark.parametrize("kind", KINDS)
def test_recollection_invalidates_index(tmp_path, kind):
    """A same-size re-collection (other files) leaves the index stale in
    both packages; the next extend rebuilds it, byte-identically."""
    jdir, tdir = twin_stores(tmp_path, kind)
    build(jfs, jdir, kind)
    build(tfs, tdir, kind)
    for d in (jdir, tdir):
        write_store(d, kind, 7, seed=3, prefix="h")
    assert not is_current(tfs, tdir, kind, 7) and not is_current(jfs, jdir, kind, 7)
    extend(jfs, jdir, kind)
    extend(tfs, tdir, kind)
    assert index_files(tdir) == index_files(jdir)
    assert is_current(tfs, tdir, kind, 7)


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_reads_the_others_index(tmp_path, kind):
    jdir, tdir = twin_stores(tmp_path, kind)
    build(jfs, jdir, kind)
    build(tfs, tdir, kind)
    for d in (jdir, tdir):
        write_store(d, kind, 3, seed=5, prefix="g", overwrite=False)
    extend(jfs, jdir, kind)
    extend(tfs, tdir, kind)
    n_feat = N_DICT if kind == "indexed" else F
    for sub in (None, 8):
        for feat in range(n_feat):
            want = reader(jfs, jdir, kind, sub).feature(feat)
            np.testing.assert_array_equal(reader(tfs, jdir, kind, sub).feature(feat), want)
            np.testing.assert_array_equal(reader(jfs, tdir, kind, sub).feature(feat), want)
            assert want.dtype == np.float32 and want.shape == (sub or 10, T)


def _strip(results):
    return [(f, v, t) for f, _, v, t in results]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("absolute", [False, True], ids=["plain", "abs"])
def test_fast_path_equals_scan(tmp_path, kind, absolute):
    """The port's one-plane fast path (over a grown, two-segment index)
    equals its scan and JAX's fast path: files, order, values and times
    equal, traces bit-equal."""
    jdir, tdir = twin_stores(tmp_path, kind, n_files=9, seed=2)
    n_feat = N_DICT if kind == "indexed" else F
    loader = MemoryMappedActivationLoader(str(tdir), LAYER, batch_size=4)
    scans = [top_activations(loader, f, 5, absolute_magnitude=absolute, device="cpu")
             for f in range(n_feat)]
    for d, fs in ((jdir, jfs), (tdir, tfs)):
        build(fs, d, kind)
    fasts = [top_activations(loader, f, 5, absolute_magnitude=absolute, device="cpu")
             for f in range(n_feat)]
    jloader = JaxLoader(str(jdir), LAYER, batch_size=4)
    for f, (scan, fast) in enumerate(zip(scans, fasts)):
        want = jax_top(jloader, f, 5, absolute_magnitude=absolute)
        for got in (scan, want):
            assert _strip(fast[0]) == _strip(got[0]), f
            assert fast[1] == [float(v) for v in got[1]], f
            for (_, a, _, _), (_, b, _, _) in zip(fast[0], got[0]):
                np.testing.assert_array_equal(a, b)
