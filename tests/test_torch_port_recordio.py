"""The port's `recordio` against the JAX package's, on the CPU: the same
records make the same bytes (.rec and .idx) whichever package writes them,
the JAX package's native writer included, and each package reads the
other's files, indexed and sequential, multi-label headers included. A PNG
image record packed by either package decodes in the other to the same
pixels.
"""
import numpy as np
import pytest

import mxnet_tpu.recordio as jrec
from mxnet_tpu import image as jimage

from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError


def _records(seed, n=9):
    """(key, header, payload): single and multi-label headers, payloads of
    every length mod 4 (the padding), one empty."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        if i % 3 == 2:
            label = rng.rand(rng.randint(1, 5)).astype(np.float32)
        else:
            label = float(rng.randint(0, 1000))
        payload = rng.bytes(0 if i == 4 else rng.randint(1, 60))
        out.append((i * 10 + 3, (0, label, i, 7 * i), payload))
    return out


def _write(mod, prefix, records):
    w = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for key, header, payload in records:
        w.write_idx(key, mod.pack(header, payload))
    w.close()


def _same_header(a, b):
    assert (a.flag, a.id, a.id2) == (b.flag, b.id, b.id2)
    np.testing.assert_array_equal(np.asarray(a.label), np.asarray(b.label))


@pytest.mark.parametrize("native", [False, True])
def test_files_are_byte_identical(tmp_path, monkeypatch, native):
    """The JAX package writes through its native writer unless
    MXTPU_PY_RECORDIO is set; both give the port's bytes."""
    if not native:
        monkeypatch.setenv("MXTPU_PY_RECORDIO", "1")
    records = _records(1)
    _write(jrec, str(tmp_path / "j"), records)
    _write(trec, str(tmp_path / "t"), records)
    for ext in (".rec", ".idx"):
        assert (tmp_path / ("t" + ext)).read_bytes() == \
            (tmp_path / ("j" + ext)).read_bytes(), ext
    for key, header, payload in records:
        assert trec.pack(header, payload) == jrec.pack(header, payload)


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)])
def test_each_package_reads_the_others_files(tmp_path, monkeypatch, writer,
                                             reader):
    monkeypatch.setenv("MXTPU_PY_RECORDIO", "1")
    records = _records(2)
    prefix = str(tmp_path / "r")
    _write(writer, prefix, records)
    r = reader.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    assert list(r.keys) == [k for k, _, _ in records]
    for key, header, payload in reversed(records):   # random access
        h, s = reader.unpack(r.read_idx(key))
        _same_header(h, trec.IRHeader(*trec.unpack(
            trec.pack(header, payload))[0]))
        assert s == payload
    r.close()
    seq = reader.MXRecordIO(prefix + ".rec", "r")   # sequential
    for _, header, payload in records:
        h, s = reader.unpack(seq.read())
        assert s == payload and h.id == header[2]
    assert seq.read() is None
    seq.reset()
    assert reader.unpack(seq.read())[1] == records[0][2]
    seq.close()


def test_unpack_of_multi_label_headers_matches():
    for _, header, payload in _records(3):
        buf = jrec.pack(header, payload)
        th, ts = trec.unpack(buf)
        jh, js = jrec.unpack(buf)
        _same_header(th, jh)
        assert ts == js


@pytest.mark.parametrize("direction", ["port_writes", "jax_writes"])
def test_png_image_records_cross_decode(tmp_path, direction):
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    header = trec.IRHeader(0, 5.0, 1, 0)
    if direction == "port_writes":
        buf = trec.pack_img(header, img, img_fmt=".png")
        h, got = jrec.unpack_img(buf)
    else:
        buf = jrec.pack_img(header, img, img_fmt=".png")
        h, got = trec.unpack_img(buf)
    assert h.label == 5.0
    np.testing.assert_array_equal(np.asarray(got), img)
    h, gray = trec.unpack_img(jrec.pack_img(header, img, img_fmt=".png"),
                              iscolor=0)
    np.testing.assert_array_equal(
        gray, jimage.imdecode(jimage.imencode(img, fmt=".png"), flag=0,
                              to_ndarray=False))


def test_missing_file_and_bad_magic_raise(tmp_path):
    with pytest.raises(MXNetError, match="nope.rec"):
        trec.MXRecordIO(str(tmp_path / "nope.rec"), "r")
    (tmp_path / "bad.rec").write_bytes(b"\x00" * 16)
    r = trec.MXRecordIO(str(tmp_path / "bad.rec"), "r")
    with pytest.raises(MXNetError, match="magic"):
        r.read()
    r.close()
    with pytest.raises(MXNetError, match="flag"):
        trec.MXRecordIO(str(tmp_path / "x.rec"), "a")


def test_reader_pickles_and_reopens(tmp_path):
    import pickle

    records = _records(5, n=4)
    prefix = str(tmp_path / "p")
    _write(trec, prefix, records)
    r = trec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    r2 = pickle.loads(pickle.dumps(r))
    key = records[2][0]
    assert r2.read_idx(key) == r.read_idx(key)
    r.close()
    r2.close()
