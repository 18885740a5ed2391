"""freud_tpu_torch's framework-free scripts against the JAX package's:
``plot_polysemantic`` (its loader on the port's copy of the bundled CSV
equal to JAX's, and its CLI's plots), ``download_audio_datasets`` (its
extraction and resume markers on archives built here; nothing touches the
network) and ``parity_check`` (check 1 on the port's copy of the bundled
FLAC; checks 2-5 report "skipped" without their assets). The port's
assets are byte-identical to the JAX package's."""

import io
import tarfile
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["polyesemantic_count.csv", "example_audio.flac"])
def test_assets_are_byte_identical(name):
    port = REPO / "freud_tpu_torch" / "assets" / name
    assert port.read_bytes() == (REPO / "freud_tpu" / "assets" / name).read_bytes()


def test_polysemantic_loader_matches_jax(tmp_path):
    """The wide bundled CSV melts to the same long samples as JAX's loader,
    and a long headered CSV stays long in both."""
    from freud_tpu.scripts import plot_polysemantic as jplot
    from freud_tpu_torch.scripts import plot_polysemantic as tplot

    assert Path(tplot._DEFAULT_CSV).parent == REPO / "freud_tpu_torch" / "assets"
    got, gv, gg = tplot.load_samples(tplot._DEFAULT_CSV)
    want, wv, wg = jplot.load_samples(jplot._DEFAULT_CSV)
    assert (gv, gg) == (wv, wg) == ("activation", "phoneme")
    assert got.reset_index(drop=True).equals(want.reset_index(drop=True))
    assert got.groupby(gg)[gv].count().min() > 10
    p = tmp_path / "long.csv"
    p.write_text("phoneme,activation,count\nAA,0.5,3\nAA,0.7,3\nIY,1.5,2\n")
    got, gv, gg = tplot.load_samples(str(p))
    want, *_ = jplot.load_samples(str(p))
    assert (gv, gg) == ("activation", "phoneme") and len(got) == 3
    assert got.equals(want)


def test_plot_polysemantic_cli(tmp_path):
    from freud_tpu_torch.scripts import plot_polysemantic

    out = tmp_path / "plots"
    plot_polysemantic.main(["--out", str(out)])
    assert sorted(p.name for p in out.glob("*.png")) == ["histograms.png", "means_ci.png"]


def _archives(root: Path) -> dict:
    """A .tar.gz, a .tar and a .zip of one small file each, and a plain csv."""
    payload = {"a.tar.gz": "gz", "b.tar": "", "c.zip": None, "d.csv": None}
    for name, mode in payload.items():
        if mode is not None:
            with tarfile.open(root / name, f"w:{mode}" if mode else "w") as t:
                data = f"inside {name}".encode()
                info = tarfile.TarInfo(f"{name.split('.')[0]}/member.txt")
                info.size = len(data)
                t.addfile(info, io.BytesIO(data))
        elif name.endswith(".zip"):
            with zipfile.ZipFile(root / name, "w") as z:
                z.writestr("c/member.txt", f"inside {name}")
        else:
            (root / name).write_text("id,label\n1,dog\n")
    return payload


def test_downloader_extracts_without_the_network(tmp_path, monkeypatch):
    """``download_dataset`` over a stand-in dataset whose "downloads" copy
    archives built here: every archive extracts (and is removed), the csv
    stays, a second run skips by its markers, and an archive left by an
    interrupted run is extracted, not downloaded again."""
    import shutil

    from freud_tpu_torch.scripts import download_audio_datasets as dl

    src = tmp_path / "src"
    src.mkdir()
    names = list(_archives(src))
    fetched = []

    def fake_download(url, dest, chunk_size=1 << 20):
        fetched.append(url)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src / url.rsplit("/", 1)[-1], dest)
        return dest

    monkeypatch.setattr(dl, "download_file", fake_download)
    monkeypatch.setitem(dl.DATASETS, "stand_in", [f"https://example.invalid/{n}"
                                                  for n in names])
    dl.download_dataset("stand_in", str(tmp_path / "out"))
    out = tmp_path / "out" / "stand_in"
    for stem in ("a", "b", "c"):
        assert (out / stem / "member.txt").read_text().startswith("inside")
    assert not any((out / n).exists() for n in names[:3]) and (out / "d.csv").exists()
    assert len(fetched) == 4
    dl.download_dataset("stand_in", str(tmp_path / "out"))
    assert len(fetched) == 4  # every marker present: nothing fetched again
    (out / ".a.tar.gz.extracted").unlink()
    shutil.copy(src / "a.tar.gz", out / "a.tar.gz")  # an interrupted run's archive
    dl.download_dataset("stand_in", str(tmp_path / "out"), keep_archives=True)
    assert len(fetched) == 4 and (out / "a.tar.gz").exists()
    with pytest.raises(ValueError, match="Unknown dataset"):
        dl.download_dataset("nope", str(tmp_path / "out"))
    with pytest.raises(SystemExit):
        dl.main(["--out", str(tmp_path), "--dataset", "nope"])
    assert dl.DATASETS["librispeech"] == __import__(
        "freud_tpu.scripts.download_audio_datasets",
        fromlist=["DATASETS"]).DATASETS["librispeech"]


def test_parity_check_mel_and_skips(capsys, monkeypatch, tmp_path):
    """Check 1 passes on the port's FLAC on the CPU; with no weights,
    ranks or openai-whisper, checks 2-5 report "skipped"."""
    from freud_tpu_torch.scripts import parity_check

    monkeypatch.setenv("FREUD_WHISPER_DIR", str(tmp_path))
    monkeypatch.setenv("FREUD_TOKENIZER_DIR", str(tmp_path))
    assert Path(parity_check._default_flac()) == (
        REPO / "freud_tpu_torch" / "assets" / "example_audio.flac")
    assert parity_check.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[mel]" in out and "(OK)" in out
    for tag in ("[encoder]", "[suppression]", "[transcript]", "[words]"):
        line = next(ln for ln in out.splitlines() if ln.startswith(tag))
        assert "skipped" in line, line
    assert "1/1 checks passed (4 skipped" in out
