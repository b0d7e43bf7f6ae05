"""The port's native host paths: ``data/native_pipe.py`` (C++ jpeg decode
and preprocess) and ``models/native_tokenizer.py`` (C++ WordPiece), against
the JAX package's wrappers of the same libraries (equal outputs) and the
port's PIL and Python paths (tests/test_native_pipe.py's bounds; equal
ids and masks), and the hooks that take them: the datasets' path
transform, ``iter_batches``' batch path, ``cli/common.get_transform
--native-pipe`` and ``load_tokenizer(prefer_native=True)``."""
import argparse
import io
import json

import numpy as np
import pytest

from candidate_reranking_cir_tpu.data import native_pipe as jpipe
from candidate_reranking_cir_tpu_torch.data import native_pipe
from candidate_reranking_cir_tpu_torch.data.preprocessing import (
    CLIP_STD,
    make_transform,
)
from candidate_reranking_cir_tpu_torch.models import native_tokenizer
from candidate_reranking_cir_tpu_torch.models.tokenizer import (
    WordPieceTokenizer,
    build_test_vocab,
    load_tokenizer,
)

if not (native_pipe.native_available()
        and native_tokenizer.native_available()):
    pytest.skip("native libraries not built (make -C native)",
                allow_module_level=True)

PIL_Image = pytest.importorskip("PIL.Image")

TEXTS = ["The DRESS is red, and blue!", "a dog with a cat.", "drèss",
         "CAFÉ naïve", "zzqx 123", "shirt dresss dressed dressing",
         "hello\tworld\nnewline", "漢字 test", "...!!??", "", "a" * 150]


def _jpeg(arr, quality=92) -> bytes:
    buf = io.BytesIO()
    PIL_Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _noise(seed, h, w):
    return np.random.default_rng(seed).integers(0, 255, size=(h, w, 3),
                                                dtype=np.uint8)


def _diff255(a, b):
    return np.abs(a - b) * CLIP_STD[None, None] * 255


@pytest.mark.parametrize("shape", [(347, 272), (90, 308), (64, 64)])
@pytest.mark.parametrize("kind", ["targetpad", "squarepad"])
def test_jpeg_equals_jax_and_holds_pil_bounds(shape, kind):
    data = _jpeg(_noise(sum(shape), *shape))
    square = kind == "squarepad"
    out = native_pipe.process_jpeg_bytes(data, 96, 1.25, square)
    np.testing.assert_array_equal(
        out, jpipe.process_jpeg_bytes(data, 96, 1.25, square))
    ref = make_transform(kind, 96, 1.25)(PIL_Image.open(io.BytesIO(data)))
    diff = _diff255(out, ref)
    assert diff.mean() < 0.5 and diff.max() < 10, (diff.mean(), diff.max())


def test_rgb_equals_jax_and_holds_pil_bounds():
    arr = _noise(1, 120, 80)
    out = native_pipe.process_rgb(arr, dim=64)
    np.testing.assert_array_equal(out, jpipe.process_rgb(arr, dim=64))
    ref = make_transform("targetpad", 64, 1.25)(PIL_Image.fromarray(arr))
    assert _diff255(out, ref).max() < 10
    with pytest.raises(ValueError, match="H, W, 3"):
        native_pipe.process_rgb(arr[..., 0], dim=64)


def test_batch_equals_jax_and_single():
    datas = [_jpeg(_noise(i, 40 + 7 * i, 30 + 5 * i), 90) for i in range(6)]
    batch = native_pipe.process_jpeg_batch(datas, dim=64, num_threads=3)
    np.testing.assert_array_equal(
        batch, jpipe.process_jpeg_batch(datas, dim=64, num_threads=3))
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(batch[i],
                                      native_pipe.process_jpeg_bytes(d, 64))


def test_decode_failures_raise():
    with pytest.raises(ValueError, match="code"):
        native_pipe.process_jpeg_bytes(b"not a jpeg", 64)
    good = _jpeg(_noise(2, 30, 30))
    with pytest.raises(ValueError, match=r"indices \[1\]"):
        native_pipe.process_jpeg_batch([good, b"junk", good], dim=64)


@pytest.fixture
def cirr_tree(tmp_path):
    base = tmp_path / "cirr_dataset"
    (base / "cirr" / "captions").mkdir(parents=True)
    (base / "cirr" / "image_splits").mkdir(parents=True)
    (base / "img").mkdir()
    relpath = {}
    for i in range(5):
        PIL_Image.fromarray(_noise(5 + i, 40 + i, 30 + i)).save(
            base / "img" / f"im{i}.jpg", quality=92)
        relpath[f"im{i}"] = f"img/im{i}.jpg"
    (base / "cirr" / "image_splits" / "split.rc2.val.json").write_text(
        json.dumps(relpath))
    (base / "cirr" / "captions" / "cap.rc2.val.json").write_text("[]")
    return tmp_path


def test_dataset_path_transform_and_batch_path(cirr_tree):
    """The dataset hands the native transform paths; ``iter_batches``
    decodes whole batches through ``batch_from_paths``, with the per-item
    path's names and pixels."""
    from candidate_reranking_cir_tpu_torch.data.datasets import CIRRDataset
    from candidate_reranking_cir_tpu_torch.retrieval.index import iter_batches

    nat = native_pipe.make_native_transform("targetpad", 32, 1.25)
    assert nat.wants_path
    ds = CIRRDataset(cirr_tree, "val", "classic", nat)
    sample = ds[0]
    assert sample["image"].shape == (32, 32, 3)
    assert sample["image"].dtype == np.float32

    calls = []
    native_batch = nat.batch_from_paths

    def batch_fn(paths):
        calls.append(len(paths))
        return native_batch(paths)

    per_item = native_pipe.make_native_transform("targetpad", 32, 1.25)
    del per_item.batch_from_paths
    nat.batch_from_paths = batch_fn
    got = list(iter_batches(ds, 2))
    ref = list(iter_batches(CIRRDataset(cirr_tree, "val", "classic",
                                        per_item), 2))
    assert calls == [2, 2, 1]
    assert [n for ns, _ in got for n in ns] == \
        [n for ns, _ in ref for n in ns]
    np.testing.assert_array_equal(np.concatenate([b for _, b in got]),
                                  np.concatenate([b for _, b in ref]))
    # a skip_errors dataset keeps the per-item path (it drops bad rows)
    calls.clear()
    list(iter_batches(CIRRDataset(cirr_tree, "val", "classic", nat,
                                  skip_errors=True), 2))
    assert calls == []


def test_get_transform_native_pipe(capsys, monkeypatch):
    from candidate_reranking_cir_tpu_torch.cli import common

    parser = common.add_common_flags(argparse.ArgumentParser())
    args = parser.parse_args(["--dataset", "CIRR", "--native-pipe",
                              "--image-size", "64"])
    transform = common.get_transform(args)
    assert transform.wants_path and hasattr(transform, "batch_from_paths")
    plain = common.get_transform(parser.parse_args(["--dataset", "CIRR"]))
    assert not getattr(plain, "wants_path", False)
    monkeypatch.setattr(native_pipe, "native_available", lambda: False)
    fallback = common.get_transform(args)
    assert not getattr(fallback, "wants_path", False)
    assert "falling back to PIL" in capsys.readouterr().out


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab = build_test_vocab()
    path.write_text("".join(tok + "\n" for tok, _ in
                            sorted(vocab.items(), key=lambda kv: kv[1])))
    return path


@pytest.mark.parametrize("set_enc", [False, True])
@pytest.mark.parametrize("max_len", [8, 40])
def test_native_tokenizer_matches_python(vocab_file, set_enc, max_len):
    py = WordPieceTokenizer(build_test_vocab())
    nat = native_tokenizer.NativeWordPieceTokenizer(vocab_file)
    for key in ("vocab_size", "pad_id", "cls_id", "sep_id", "unk_id",
                "enc_token_id", "dec_token_id"):
        assert getattr(nat, key) == getattr(py, key), key
    i1, m1 = py.encode(TEXTS, max_len, set_enc_token=set_enc,
                       overflow="truncate")
    i2, m2 = nat.encode(TEXTS, max_len, set_enc_token=set_enc,
                        overflow="truncate")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(m1, m2)


def test_native_tokenizer_overflow_policy(vocab_file):
    caption = " ".join(["the red dress and the blue shirt"] * 7)
    for tok in (WordPieceTokenizer(build_test_vocab()),
                native_tokenizer.NativeWordPieceTokenizer(vocab_file)):
        before = tok.overflow_count
        with pytest.raises(ValueError, match="exceed the static text bucket"):
            tok.encode([caption], 8)
        with pytest.warns(UserWarning, match="1/1 caption"):
            tok.encode([caption], 8, overflow="warn")
        ids, _ = tok.encode([caption], 8, overflow="truncate")
        assert ids.shape == (1, 8)
        assert tok.overflow_count == before + 2


def test_load_tokenizer_prefers_native(vocab_file, tmp_path):
    assert isinstance(load_tokenizer(vocab_file),
                      native_tokenizer.NativeWordPieceTokenizer)
    assert isinstance(load_tokenizer(vocab_file, prefer_native=False),
                      WordPieceTokenizer)
    with pytest.raises(FileNotFoundError):
        native_tokenizer.NativeWordPieceTokenizer(tmp_path / "missing.txt")
