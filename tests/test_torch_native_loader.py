"""The port's native reader (``ldm_tf2_tpu_torch/data/native``) against the
JAX package's native module and the port's own Python path, bit for bit.

On seeded records written by the port's writers: CRC32C, the mapped record
file (CRC-checked), the framing scan and ``pread``, the Example walk and
``decode_and_process`` (libjpeg's decode and the transform, flipped and not)
equal the JAX package's ``ldm_tf2_tpu.data.native`` and the port's Python
path (``tfrecord.py``, ``example_proto.py``, PIL through
``dataset.process_image``).  Then the streaming and the indexed loaders
give equal batches with the reader on and off; a record libjpeg rejects (a
PNG) is decoded in Python and counted; and where the library does not
build (a compiler name that does not exist), ``available()`` is False, the
loaders take the Python path, and ``require()`` and ``native=True`` raise.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from ldm_tf2_tpu.data import native as jnative
from ldm_tf2_tpu_torch.data import dataset, indexed
from ldm_tf2_tpu_torch.data import native
from ldm_tf2_tpu_torch.data.example_proto import decode_example, encode_example
from ldm_tf2_tpu_torch.data.tfrecord import TFRecordReader, TFRecordWriter
from ldm_tf2_tpu_torch.data.tfrecord import crc32c as py_crc32c

SIZES = [(20, 30), (31, 17), (16, 16), (40, 23)]


def _image(rng, w, h, fmt="JPEG"):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, fmt)
    return buf.getvalue()


def _write(path, n, seed, png_at=()):
    """``n`` Example records (an image, a caption of 3-9 ids) in one file;
    the records at ``png_at`` hold a PNG."""
    rng = np.random.default_rng(seed)
    records = []
    with TFRecordWriter(path) as w:
        for i in range(n):
            width, height = SIZES[i % len(SIZES)]
            image = _image(rng, width, height, "PNG" if i in png_at else "JPEG")
            caption = [101] + [int(x) for x in rng.integers(1000, 30000, i % 7 + 1)] + [102]
            records.append(encode_example({"image": image, "caption": caption}))
            w.write(records[-1])
    return records


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    paths = [str(root / f"part_{i}.tfrecord") for i in range(2)]
    records = [_write(p, 12, 40 + i) for i, p in enumerate(paths)]
    return paths, records


@pytest.fixture(autouse=True)
def _enabled():
    native.set_enabled(True)
    yield
    native.set_enabled(True)


def test_the_library_builds_with_its_decode():
    from ldm_tf2_tpu_torch.ops._build import BUILD_DIR

    native.require()
    assert native.available() and native.has_decode()
    assert os.path.dirname(native.library_path()) == BUILD_DIR  # not beside the source
    assert os.path.exists(native.library_path())
    assert not os.path.exists(native.library_path(jpeg=False))  # libjpeg is here


def test_crc32c_matches_jax_and_python():
    for data in (b"", b"a", b"123456789", bytes(range(256)) * 7, os.urandom(1001)):
        assert native.crc32c(data) == jnative.crc32c(data) == py_crc32c(data)


def test_record_file_scan_and_pread_match(shards):
    paths, records = shards
    for path, recs in zip(paths, records):
        rf = native.NativeRecordFile(path, verify_crc=True)
        assert list(rf) == recs == list(TFRecordReader(path)) == \
            list(jnative.NativeRecordFile(path, verify_crc=True))
        rf.close()
        scanned = native.scan_index(path)
        np.testing.assert_array_equal(scanned, jnative.scan_index(path))
        for (offset, length), rec in zip(scanned, recs):
            assert native.pread(path, int(offset), int(length)) == rec
    np.testing.assert_array_equal(indexed.build_index(paths, native=True),
                                  indexed.build_index(paths, native=False))
    assert native.scan_index(paths[0] + ".missing") is None


def test_record_file_refuses_a_corrupt_crc(tmp_path):
    path = str(tmp_path / "t.tfrecord")
    with TFRecordWriter(path) as w:
        w.write(b"one")
        w.write(b"x" * 5000)
    data = bytearray(open(path, "rb").read())
    data[13] ^= 1  # inside the first record's payload
    open(path, "wb").write(bytes(data))
    assert len(native.NativeRecordFile(path)) == 2
    with pytest.raises(IOError):
        native.NativeRecordFile(path, verify_crc=True)
    empty = str(tmp_path / "empty.tfrecord")
    open(empty, "wb").close()
    assert len(native.NativeRecordFile(empty)) == 0
    assert native.scan_index(empty).shape == (0, 2)


def test_example_walk_matches(shards):
    _, records = shards
    for rec in records[0] + records[1]:
        example = decode_example(rec)
        assert native.example_image_bytes(rec) == jnative.example_image_bytes(rec) == \
            example["image"][0]
        for max_len in (3, 12):
            want = np.zeros(max_len, np.int64)
            ids = np.asarray(example["caption"], np.int64)[:max_len]
            want[:len(ids)] = ids
            np.testing.assert_array_equal(native.example_caption(rec, max_len), want)
            np.testing.assert_array_equal(jnative.example_caption(rec, max_len), want)
    plain = encode_example({"label": [3]})
    assert native.example_image_bytes(plain) is None
    assert native.example_caption(plain) is None


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("size", [16, 24])
def test_decode_and_process_is_bit_equal(shards, flip, size):
    _, records = shards
    for rec in records[0][:len(SIZES)]:
        jpeg = native.example_image_bytes(rec)
        got = native.decode_and_process(jpeg, size, flip)
        assert got.dtype == np.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, jnative.decode_and_process(jpeg, size, flip))
        want = dataset._make_example(rec, size, flip, False, 77)  # PIL, then the chain
        np.testing.assert_array_equal(got, want)
    assert native.decode_and_process(b"not a jpeg", size, flip) is None


def _batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("loader", ["streaming", "indexed"])
def test_loaders_give_equal_batches_native_on_and_off(shards, loader):
    paths, _ = shards
    kw = dict(batch_size=4, image_size=16, flip=True, max_seq_len=8, random_seed=3)

    def run(flag):
        native.set_enabled(flag)
        if loader == "streaming":
            return _batches(dataset.create_dataset(paths, **kw), 5)
        return _batches(indexed.create_indexed_dataset(paths, start_step=1, **kw), 5)

    before = native.fallbacks
    on, off = run(True), run(False)
    _equal_batches(on, off)
    assert native.fallbacks == before
    assert dataset.example_maker(None) is dataset._make_example  # disabled
    native.set_enabled(True)
    assert dataset.example_maker(None) is dataset._make_example_native
    assert dataset.example_maker(False) is dataset._make_example


def test_a_record_libjpeg_rejects_is_decoded_in_python_and_counted(tmp_path):
    path = str(tmp_path / "mixed.tfrecord")
    records = _write(path, 8, 7, png_at=(2, 5))
    make = dataset.example_maker(True)
    assert make is dataset._make_example_native
    before = native.fallbacks
    for rec in records:
        got = make(rec, 16, True, True, 8)
        want = dataset._make_example(rec, 16, True, True, 8)
        for u, v in zip(got, want):
            np.testing.assert_array_equal(u, v)
    assert native.fallbacks - before == 2  # the two PNG records
    kw = dict(batch_size=8, image_size=16, max_seq_len=8, random_seed=0)
    on = _batches(indexed.create_indexed_dataset([path], native=True, **kw), 2)
    off = _batches(indexed.create_indexed_dataset([path], native=False, **kw), 2)
    _equal_batches(on, off)


def test_a_failed_build_takes_the_python_path_and_require_raises(monkeypatch, shards, capsys):
    paths, _ = shards
    monkeypatch.setattr(native, "CXX", "no-such-compiler-for-the-native-reader")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", "")
    assert not native.available() and not native.has_decode()
    err = capsys.readouterr().err
    assert err.count("did not build") == 1 and "no-such-compiler" in err
    native.available()
    assert "did not build" not in capsys.readouterr().err  # printed once
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.require()
    with pytest.raises(RuntimeError, match="did not build"):
        indexed.create_indexed_dataset(paths, batch_size=2, image_size=16, native=True)
    with pytest.raises(RuntimeError, match="did not build"):
        dataset.create_dataset(paths, batch_size=2, image_size=16, native=True)
    assert dataset.example_maker(None) is dataset._make_example
    np.testing.assert_array_equal(indexed.build_index(paths),
                                  indexed.build_index(paths, native=False))
