"""``torcheval_tpu_torch/utils/npz.py`` against the JAX package's
``utils/npz.py``: the same archives decode to equal arrays, with the same
leaves zero-copy views (and the same ones copied), and the same errors."""

import io
import zipfile

import numpy as np
import pytest

from torcheval_tpu.utils import npz as jax_npz
from torcheval_tpu_torch.utils import npz as port_npz

RNG = np.random.default_rng(11)


def _savez(arrays, compressed=False) -> bytes:
    buf = io.BytesIO()
    (np.savez_compressed if compressed else np.savez)(buf, **arrays)
    return buf.getvalue()


def _stored(members) -> bytes:
    """A STORED zip of ``{name: (npy bytes, extra field)}``: the extra
    field's length moves each member's data to a chosen alignment."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression=zipfile.ZIP_STORED) as zf:
        for name, (data, extra) in members.items():
            info = zipfile.ZipInfo(name + ".npy")
            info.extra = extra
            zf.writestr(info, data)
    return buf.getvalue()


def _npy(arr) -> bytes:
    b = io.BytesIO()
    np.save(b, arr, allow_pickle=False)
    return b.getvalue()


def _aligned_archive(arr) -> bytes:
    """One member whose data starts on a 64-byte boundary: 30-byte local
    header + 5-byte name + the extra field pad the npy magic to offset 64,
    and np.save pads its own header to a multiple of 64."""
    extra_len = 64 - 30 - len("x.npy")
    extra = b"\xfe\xca" + (extra_len - 4).to_bytes(2, "little") + b"\0" * (extra_len - 4)
    return _stored({"x": (_npy(arr), extra)})


def _unaligned_archive(arr) -> bytes:
    extra_len = 64 - 30 - len("x.npy") + 1
    extra = b"\xfe\xca" + (extra_len - 4).to_bytes(2, "little") + b"\0" * (extra_len - 4)
    return _stored({"x": (_npy(arr), extra)})


CASES = {
    "savez_mixed": lambda: _savez({
        "f32": RNG.random((7, 3)).astype(np.float32),
        "i64": RNG.integers(-9, 9, 11),
        "b": RNG.random(5) > 0.5,
        "u8": RNG.integers(0, 255, 13).astype(np.uint8),
    }),
    "aligned_f64": lambda: _aligned_archive(RNG.random((4, 5))),
    "aligned_i32": lambda: _aligned_archive(RNG.integers(0, 99, (3, 3)).astype(np.int32)),
    "unaligned_f64": lambda: _unaligned_archive(RNG.random(9)),
    "compressed": lambda: _savez({"a": RNG.random(33).astype(np.float32), "n": np.arange(5)},
                                 compressed=True),
    "fortran": lambda: _aligned_archive(np.asfortranarray(RNG.random((5, 4)).astype(np.float32))),
    "zero_d": lambda: _savez({"s": np.float32(2.5), "i": np.asarray(7, np.int32)}),
    "empty": lambda: _savez({"e": np.zeros((0, 4), np.float32), "e1": np.zeros(0, np.int64)}),
    "raw_words": lambda: _savez({"v": RNG.integers(0, 2**16, 6).astype(np.uint16).view("V2")}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("as_type", ["bytes", "bytearray", "memoryview", "uint8"])
def test_views_equal_jax(case, as_type):
    raw = CASES[case]()
    buf = {"bytes": raw, "bytearray": bytearray(raw), "memoryview": memoryview(raw),
           "uint8": np.frombuffer(raw, np.uint8)}[as_type]
    want = jax_npz.npz_views(buf)
    got = port_npz.npz_views(buf)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
        # the same leaves are zero-copy views, the same ones copies
        assert got[k].flags.owndata == want[k].flags.owndata, k
        assert got[k].flags.f_contiguous == want[k].flags.f_contiguous, k
        np.testing.assert_array_equal(got[k], np.load(io.BytesIO(raw))[k])


def test_aligned_leaf_is_a_view_and_unaligned_a_copy():
    arr = RNG.random((4, 5))
    view = port_npz.npz_views(_aligned_archive(arr))["x"]
    copy = port_npz.npz_views(_unaligned_archive(arr))["x"]
    assert not view.flags.owndata and copy.flags.owndata
    np.testing.assert_array_equal(view, arr)
    np.testing.assert_array_equal(copy, arr)
    assert port_npz._views_share_buffer({"x": view}, None)


def test_read_only_buffer_gives_read_only_views():
    raw = _aligned_archive(RNG.random(8))
    assert not port_npz.npz_views(raw)["x"].flags.writeable
    assert not jax_npz.npz_views(raw)["x"].flags.writeable


def test_object_array_raises_like_np_load():
    raw = io.BytesIO()
    np.savez(raw, o=np.asarray([{"a": 1}, None], dtype=object))
    for mod in (jax_npz, port_npz):
        with pytest.raises(ValueError):
            mod.npz_views(raw.getvalue())


@pytest.mark.parametrize("junk", [b"", b"not a zip at all", b"PK\x03\x04" + b"\0" * 40])
def test_not_a_zip_raises_the_same_error_class(junk):
    errs = []
    for mod in (jax_npz, port_npz):
        with pytest.raises(mod.NPZ_FORMAT_ERRORS) as ctx:
            mod.npz_views(junk)
        errs.append(type(ctx.value))
    assert errs[0] is errs[1]
    assert port_npz.NPZ_FORMAT_ERRORS == jax_npz.NPZ_FORMAT_ERRORS
