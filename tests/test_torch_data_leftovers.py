"""The port's manifest and loader leftovers on the CPU, against the JAX package.

``specdata.npz`` splits and gen_specs' ``.npz`` branch (which fails in the
JAX CLI), CSV column types and the inner merge against pandas, the Neal
filter, ``DataFrameImageSource`` (index stream, batches, extras), the
loader's BILINEAR resize and its native decode, the latent cache over a
manifest source, and the ACGAN's manifest mode: its rows and acoustic
indices against the JAX ``_manifest_source`` to 1e-12, and one CLI epoch.
"""

import csv
import functools
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from spectrogramgenai_tpu.cli import gen_specs as jgen  # noqa: E402
from spectrogramgenai_tpu.cli import train_acgan as jacgan  # noqa: E402
from spectrogramgenai_tpu.core import config as jc  # noqa: E402
from spectrogramgenai_tpu.data import manifest as jmanifest  # noqa: E402
from spectrogramgenai_tpu.data import pipeline as jpipeline  # noqa: E402
from spectrogramgenai_tpu_torch.audio.export import spec_png_name  # noqa: E402
from spectrogramgenai_tpu_torch.cli import gen_specs as tgen  # noqa: E402
from spectrogramgenai_tpu_torch.cli import train_acgan as tacgan  # noqa: E402
from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.data import manifest as tmanifest  # noqa: E402
from spectrogramgenai_tpu_torch.data import native_png  # noqa: E402
from spectrogramgenai_tpu_torch.data import pipeline as tpipeline  # noqa: E402
from spectrogramgenai_tpu_torch.data.latent_cache import LatentCacheSource  # noqa: E402
from spectrogramgenai_tpu_torch.models import gan as tg  # noqa: E402
from spectrogramgenai_tpu_torch.train import acgan_task as ttask  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402, F401

CLASSES = ["owl", "robin", "wren"]
LABEL_COLUMNS = ["file_name", "begin_time", "end_time", "common_name", "confidence"]


def _records(df: pd.DataFrame) -> list[dict]:
    return df.to_dict("records")


def _specdata(path, n_train: int = 9, with_columns: bool = True, seed: int = 0):
    """A specdata.npz like the reference's: object rows (index, file, begin, end, class, confidence)."""
    rng = np.random.default_rng(seed)

    def rows(n, offset):
        return np.asarray([[offset + i, f"rec{i % 3}.wav", float(3 * (i // 3)), float(3 * (i // 3) + 3),
                            CLASSES[int(rng.integers(0, 3))], float(rng.uniform(0.5, 1))] for i in range(n)],
                          dtype=object)

    extra = {"columns": np.asarray(["index0", *LABEL_COLUMNS], dtype=object)} if with_columns else {}
    np.savez(path, train_df=rows(n_train, 0), test_df=rows(4, 100), categories=np.asarray(CLASSES), **extra)
    return str(path)


@pytest.mark.parametrize("columns", ["file", "given", "positional"])
def test_load_specdata_manifest_matches_jax(tmp_path, columns):
    path = _specdata(tmp_path / "s.npz", with_columns=columns == "file")
    given = ["idx", *LABEL_COLUMNS] if columns == "given" else None
    train, test, cats = tmanifest.load_specdata_manifest(path, given)
    jtrain, jtest, jcats = jmanifest.load_specdata_manifest(path, given)
    assert cats == jcats == CLASSES
    assert train == _records(jtrain) and test == _records(jtest)
    assert list(train[0]) == list(jtrain.columns)


def test_gen_specs_reads_an_npz_manifest_where_the_jax_cli_fails(tmp_path):
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(1)
    for i in range(3):
        wavfile.write(wav_dir / f"rec{i}.wav", 22050, (rng.uniform(-0.5, 0.5, 22050 * 12) * 32767).astype(np.int16))
    npz = _specdata(tmp_path / "specdata.npz", n_train=6)
    train, _, _ = tmanifest.load_specdata_manifest(npz)
    csv_path = tmp_path / "m.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(train[0]))
        w.writeheader()
        w.writerows(train)
    assert tgen.run(npz, str(wav_dir), str(tmp_path / "npz"), batch_size=4, save_npy=True, device="cpu") == 6
    assert tgen.run(str(csv_path), str(wav_dir), str(tmp_path / "csv"), batch_size=4, save_npy=True,
                    device="cpu") == 6
    files = sorted(os.listdir(tmp_path / "npz"))
    assert files == sorted(os.listdir(tmp_path / "csv")) and len(files) == 12
    for name in files:
        assert (tmp_path / "npz" / name).read_bytes() == (tmp_path / "csv" / name).read_bytes()
    assert tgen.run(npz, str(wav_dir), str(tmp_path / "lim"), limit=2, device="cpu") == 2
    # the JAX CLI: pd.DataFrame(train_df) has the columns 0 … 5, so row["file_name"] fails
    with pytest.raises(KeyError, match="file_name"):
        jgen.run(npz, str(wav_dir), str(tmp_path / "jax"), batch_size=4)
    no_cols = _specdata(tmp_path / "nocols.npz", with_columns=False)
    with pytest.raises(ValueError, match="lacks column"):
        tgen.run(no_cols, str(wav_dir), str(tmp_path / "x"), device="cpu")


def test_csv_types_and_inner_merge_match_pandas(tmp_path):
    path = tmp_path / "ind.csv"
    path.write_text("file_path,begin_time,end_time,ACI,ADiv,common_name,note\n"
                    "rec1.wav,0,3,5.25,6,wren,a\nrec0.wav,0,3,1.5,2,owl,\nrec0.wav,0,3,1.7,2.5,owl,b\n"
                    "rec9.wav,0,3,9,,robin,c\nrec0.wav,3,6,0.1234567890123456789,1e-3,owl,d\n")
    cols, rows = tmanifest.read_csv_table(str(path))
    want = pd.read_csv(path)
    assert cols == list(want.columns)
    for c in ("begin_time", "end_time", "ACI", "ADiv"):
        got = np.asarray([r[c] for r in rows])
        np.testing.assert_array_equal(got, want[c].to_numpy())
        assert (got.dtype.kind == "i") == (want[c].dtype.kind == "i"), c

    left, _, _ = tmanifest.load_specdata_manifest(_specdata(tmp_path / "s.npz"))
    merged = tmanifest.inner_merge(left, rows, ["file_name", "begin_time", "end_time"],
                                   ["file_path", "begin_time", "end_time"])
    jleft, _, _ = jmanifest.load_specdata_manifest(str(tmp_path / "s.npz"))
    jmerged = jleft.merge(want, left_on=["file_name", "begin_time", "end_time"],
                          right_on=["file_path", "begin_time", "end_time"])
    assert list(merged[0]) == list(jmerged.columns)  # common_name_x / _y as pandas names them
    assert len(merged) == len(jmerged) > 3  # rec0's (0, 3) twice in the CSV: every pair
    for got, exp in zip(merged, _records(jmerged)):
        assert got.keys() == exp.keys()
        for k in got:  # an empty cell reads as NaN, in a text column too
            assert got[k] == exp[k] or (pd.isna(got[k]) and pd.isna(exp[k])), k


def test_inner_merge_keeps_left_order_where_pandas_does_not():
    # pandas' sort=False inner join takes a shortcut when the merged count equals the left's (here one
    # left row unmatched and one matched twice) that reorders the rows; the port keeps the order pandas
    # documents: left rows in order, each with its matches in right order
    left = [{"k": k, "li": i} for i, k in enumerate([1, 2, 3, 4])]
    right = [{"k": k, "ri": i} for i, k in enumerate([2, 3, 4, 3])]
    got = [(r["li"], r["ri"]) for r in tmanifest.inner_merge(left, right, ["k"], ["k"])]
    assert got == [(1, 0), (2, 1), (2, 3), (3, 2)]
    want = pd.DataFrame(left).merge(pd.DataFrame(right), on="k")
    assert sorted(zip(want["li"], want["ri"])) == got and list(zip(want["li"], want["ri"])) != got
    left.append({"k": 5, "li": 4})  # another unmatched left row, so other counts: pandas' order is the port's
    assert [(r["li"], r["ri"]) for r in tmanifest.inner_merge(left, right, ["k"], ["k"])] == got
    want = pd.DataFrame(left).merge(pd.DataFrame(right), on="k")
    assert list(zip(want["li"], want["ri"])) == got


def test_neal_test_filter_matches_jax(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for name in ("a.wav_3_3.png", "e.wav_2_2.png", "f.wav_0_0.png"):
        (img_dir / name).write_bytes(b"")
    rows = [{"file_name": f, "start_time": st, "end_time": st + 6, "class_label": c, "confidence": conf,
             "labeler": lab}
            for f, st, c, conf, lab in [("a.wav", 3.2, "robin", 0.95, "dk"), ("a.wav", 3.9, "robin", 0.99, "hh"),
                                        ("b.wav", 1.0, "wren", 0.95, "zz"), ("c.wav", 2.0, "owl", 0.5, "dk"),
                                        ("d.wav", 4.0, "robin", 0.95, "dk"), ("e.wav", 2.7, "jay", 0.97, "ms"),
                                        ("f.wav", 0.4, "owl", 0.9, "iw")]]
    got = tmanifest.neal_test_filter(rows, CLASSES, str(img_dir))
    want = _records(jmanifest.neal_test_filter(pd.DataFrame(rows), CLASSES, str(img_dir)))
    assert got == want and [r["formatted_file"] for r in got] == ["a.wav_3_3.png", "f.wav_0_0.png"]


def _images(root, rows, size=(32, 32), seed=2):
    rng = np.random.default_rng(seed)
    for r in rows:
        rgb = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
        Image.fromarray(rgb).save(os.path.join(root, spec_png_name(r["file_name"], r["begin_time"])))


def test_dataframe_source_matches_jax(tmp_path):
    path = _specdata(tmp_path / "s.npz", n_train=9)
    train, _, _ = tmanifest.load_specdata_manifest(path)
    ind = tacgan.INDEX_COLUMNS[:3]
    rng = np.random.default_rng(3)
    for r, i in zip(train, range(len(train))):
        r.update({c: float(v) for c, v in zip(ind, rng.normal(size=3))}, embeddings=f"{i},{i / 3},-1.5")
    (tmp_path / "im").mkdir()
    _images(str(tmp_path / "im"), train[:6])
    full = str(tmp_path / "elsewhere.png")  # rows whose file_name is an image path itself
    Image.fromarray(rng.integers(0, 256, (32, 32), dtype=np.uint8)).save(full)
    for r in train[6:]:
        r["file_name"] = full
    jtrain = pd.DataFrame(train)
    src = tpipeline.DataFrameImageSource(train, str(tmp_path / "im"), CLASSES, indices_columns=ind, seed=4)
    jsrc = jpipeline.DataFrameImageSource(jtrain, str(tmp_path / "im"), CLASSES, indices_columns=ind, seed=4)
    for _ in range(2):
        idx = src.epoch_indices()
        np.testing.assert_array_equal(idx, jsrc.epoch_indices())
        got, want = src.load_batch(idx[:5], num_threads=2), jsrc.load_batch(idx[:5], num_threads=2)
        assert set(got) == set(want) == {"image", "label", "embedding", "a_ind"}
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
    cached = LatentCacheSource(src, lambda x: x[..., :1, :1, :] * 2, torch.device("cpu"), encode_batch=4)
    assert cached.latents.shape == (9, 1, 1, 1) and list(cached.labels) == [CLASSES.index(r["common_name"])
                                                                             for r in train]


def test_loader_resizes_as_the_jax_pil_path_and_decodes_natively(tmp_path):
    rng = np.random.default_rng(5)
    paths = []
    for i, (h, w) in enumerate([(40, 40), (23, 57), (40, 40), (64, 16)]):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(paths[-1])
    np.save(tmp_path / "spec.npy", rng.normal(size=(30, 50)).astype(np.float32))
    paths.append(str(tmp_path / "spec.npy"))
    native_png.load_png_batch_gray.rejected = 0
    got = tpipeline.decode_gray_batch(paths, 40, 40, num_threads=2)
    want = jpipeline.decode_gray_batch(paths, 40, 40, num_threads=2)
    np.testing.assert_array_equal(got, want)  # bit-equal: PIL's BILINEAR through pil_resize
    assert native_png.load_png_batch_gray.rejected == 2  # the two PNGs of another size
    (tmp_path / "f" / "a").mkdir(parents=True)  # a folder of mixed sizes, at img_size 24
    for i, p in enumerate(paths[:4]):
        os.replace(p, tmp_path / "f" / "a" / f"{i}.png")
    src = tpipeline.ImageFolderSource(str(tmp_path / "f"), img_size=24)
    jsrc = jpipeline.ImageFolderSource(str(tmp_path / "f"), img_size=24)
    np.testing.assert_array_equal(src.load_batch(np.arange(4))["image"], jsrc.load_batch(np.arange(4))["image"])


def _acgan_inputs(tmp_path, n_train: int = 12):
    npz = _specdata(tmp_path / "specdata.npz", n_train=n_train)
    train, _, _ = tmanifest.load_specdata_manifest(npz)
    lab = tmp_path / "labels.csv"
    lab.write_text(",".join(LABEL_COLUMNS) + "\nrec0.wav,0,3,owl,0.9\n")
    rng = np.random.default_rng(6)
    ind = tmp_path / "indices.csv"
    keys = [(r["file_name"], r["begin_time"], r["end_time"]) for r in train]
    keys = list(dict.fromkeys(keys))
    with open(ind, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_path", "begin_time", "end_time", *tacgan.INDEX_COLUMNS])
        # one left row unmatched, two keys twice (pandas keeps left order only while the merged count is
        # not the left's: see test_inner_merge_keeps_left_order_where_pandas_does_not)
        for k in keys[1:] + [keys[2], keys[5], ("nowhere.wav", 0, 3)]:
            w.writerow([k[0], int(k[1]), int(k[2]), *rng.normal(size=11).round(6)])
    (tmp_path / "im").mkdir(exist_ok=True)
    _images(str(tmp_path / "im"), train, size=(32, 32))
    return npz, str(lab), str(ind), str(tmp_path / "im")


@pytest.mark.parametrize("use_aind", [True, False])
def test_acgan_manifest_source_matches_jax(tmp_path, use_aind):
    npz, lab, ind, im = _acgan_inputs(tmp_path)
    cfg = tc.ACGANConfig(use_aind=use_aind, run=tc.RunConfig(seed=3))
    jcfg = jc.ACGANConfig(use_aind=use_aind, run=jc.RunConfig(seed=3))
    src, classes = tacgan.manifest_source(cfg, npz, lab, ind, im)
    jsrc, jclasses = jacgan._manifest_source(jcfg, npz, lab, ind, im)
    assert classes == jclasses == CLASSES
    want = _records(jsrc.df)
    assert len(src.rows) == len(want) == (13 if use_aind else 12)
    for got, exp in zip(src.rows, want):
        assert got.keys() == exp.keys()
        for k in got:
            if k in tacgan.INDEX_COLUMNS:
                assert abs(got[k] - exp[k]) <= 1e-12, k
            else:
                assert got[k] == exp[k], k
    idx = src.epoch_indices()
    np.testing.assert_array_equal(idx, jsrc.epoch_indices())
    got, exp = src.load_batch(idx[:4], num_threads=2), jsrc.load_batch(idx[:4], num_threads=2)
    assert set(got) == set(exp) == ({"image", "label", "a_ind"} if use_aind else {"image", "label"})
    for k in got:
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=1e-6)
    if use_aind:
        a = np.asarray([[r[c] for c in tacgan.INDEX_COLUMNS] for r in src.rows])
        np.testing.assert_allclose(a.mean(0), 0, atol=1e-12)
        np.testing.assert_allclose(a.std(0), 1, atol=1e-12)


def test_acgan_cli_trains_an_epoch_in_manifest_mode(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ttask, "Generator", functools.partial(tg.Generator, num_blocks=1))  # 32×32 images
    npz, lab, ind, im = _acgan_inputs(tmp_path, n_train=6)
    monkeypatch.chdir(tmp_path)
    task, state = tacgan.main(["--manifest", npz, "--lab_csv", lab, "--ai_csv", ind, "--im_path", im,
                               "--use_aind", "true", "--epochs", "2", "--num_classes", "3", "--data.img_size", "32",
                               "--data.batch_size", "2", "--compute_dtype", "float32", "--device", "cpu"])
    assert state.step == 3  # epoch 1: 7 merged rows, batch 2
    with open("results/acgan/training_results.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["Epoch"] for r in rows] == ["1"] and all(np.isfinite(float(v)) for v in rows[0].values())
    assert "epoch 1: 3 steps" in capsys.readouterr().out
