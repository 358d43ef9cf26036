"""The port's own safetensors reader and writer
(``checkpoints/safetensors_io.py``) against the ``safetensors`` package:
the reader on files the package wrote, for every dtype the format's
checkpoints use; the writer's files read back by the package and equal to
its own files byte for byte; a tensor at an offset not aligned to its
element size; and the atomic replace (a failed write leaves the old file)."""

from __future__ import annotations

import json
import mmap
import os
import struct
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
safetensors = pytest.importorskip("safetensors")

from safetensors import safe_open  # noqa: E402
from safetensors.torch import load_file as st_load  # noqa: E402
from safetensors.torch import save_file as st_save  # noqa: E402

from finchat_tpu_torch.checkpoints import safetensors_io as sio  # noqa: E402

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8,
          torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool]


def _tensor(dtype: torch.dtype, shape=(3, 5), seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 7).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -1000), min(info.max, 1000), shape, generator=g,
                         dtype=torch.int64).to(dtype)


def _tree() -> dict[str, torch.Tensor]:
    out = {f"t.{str(d).split('.')[-1]}": _tensor(d, seed=i) for i, d in enumerate(DTYPES)}
    out["scalar"] = torch.tensor(2.5)
    out["empty"] = torch.zeros((0, 4))
    out["layers.0.w"] = _tensor(torch.bfloat16, (4, 2, 3), seed=99)
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_reader_against_the_package(tmp_path, dtype):
    want = {"a": _tensor(dtype), "b": _tensor(dtype, (7,), seed=1), "c": _tensor(dtype, (), 2)}
    st_save(want, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    f = sio.SafeTensorsFile(tmp_path / "x.safetensors")
    assert f.metadata() == {"format": "pt"}
    ref = st_load(str(tmp_path / "x.safetensors"))
    assert sorted(f.keys()) == sorted(ref)
    for name in want:
        got = f.read(name, torch.clone)
        assert got.dtype == dtype and got.shape == want[name].shape
        assert torch.equal(got, ref[name]) and torch.equal(got, want[name])
        assert f.dtype_shape(name) == (dtype, tuple(want[name].shape))


def test_bf16_is_viewed_not_converted(tmp_path):
    w = _tensor(torch.bfloat16, (64, 32))
    st_save({"w": w}, str(tmp_path / "w.safetensors"))
    f = sio.SafeTensorsFile(tmp_path / "w.safetensors")
    raw = np.fromfile(tmp_path / "w.safetensors", dtype=np.uint8)
    start = 8 + struct.unpack("<Q", raw[:8].tobytes())[0]

    def use(got):
        # a bf16 view into the page-aligned map at the tensor's offset in
        # the file: the bytes are the file's, no fp32 copy was made
        assert got.dtype == torch.bfloat16
        assert (got.data_ptr() - start) % mmap.PAGESIZE == 0
        assert got.view(torch.int16).numpy().tobytes() == raw[start:].tobytes()
        return got.clone()

    assert torch.equal(f.read("w", use).view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}, {"format": "pt", "note": "ü"}])
def test_writer_is_the_package_byte_for_byte(tmp_path, metadata):
    """Byte for byte where the package's layout is defined; the order of
    two or more metadata keys is not (the package keeps them in a hash
    map), so there the header is compared parsed and the data bytes as
    they are."""
    tree = _tree()
    sio.save_file(tree, tmp_path / "mine.safetensors", metadata=metadata)
    st_save(tree, str(tmp_path / "theirs.safetensors"), metadata=metadata)
    mine = (tmp_path / "mine.safetensors").read_bytes()
    theirs = (tmp_path / "theirs.safetensors").read_bytes()
    if metadata is None or len(metadata) == 1:
        assert mine == theirs
    else:
        n = struct.unpack("<Q", mine[:8])[0]
        assert mine[:8] == theirs[:8] and mine[8 + n:] == theirs[8 + n:]
        assert json.loads(mine[8:8 + n]) == json.loads(theirs[8:8 + n])
    with safe_open(str(tmp_path / "mine.safetensors"), framework="pt") as f:
        assert f.metadata() == metadata
        for name, want in tree.items():
            assert torch.equal(f.get_tensor(name), want)


def test_writer_takes_one_host_copy_at_a_time(tmp_path, monkeypatch):
    """Each tensor's host copy (a strided view's made contiguous) is taken
    when its bytes are written and gone before the next is taken."""
    copies = []
    host_bytes = sio._host_bytes

    def tracked(t):
        assert all(ref() is None for ref in copies), "an earlier host copy is still alive"
        data = host_bytes(t)
        copies.append(weakref.ref(data.obj))
        return data

    monkeypatch.setattr(sio, "_host_bytes", tracked)
    base = {f"w{i}": torch.arange(12, dtype=torch.float32).reshape(3, 4) + i for i in range(3)}
    sio.save_file({n: t.t() for n, t in base.items()}, tmp_path / "views.safetensors")
    assert len(copies) == 3 and all(ref() is None for ref in copies)
    got = st_load(str(tmp_path / "views.safetensors"))
    for name, t in base.items():
        assert torch.equal(got[name], t.t().contiguous())


def test_misaligned_offset_is_copied(tmp_path):
    """A header of a length that is not a multiple of 8 puts every tensor at
    an odd offset: the package reads such a file, and so must the port."""
    a = _tensor(torch.float32, (5,))
    b = _tensor(torch.int64, (3,), seed=1)
    c = _tensor(torch.bfloat16, (2, 3), seed=2)
    header = {"a": {"dtype": "F32", "shape": [5], "data_offsets": [0, 20]},
              "c": {"dtype": "BF16", "shape": [2, 3], "data_offsets": [20, 32]},
              "b": {"dtype": "I64", "shape": [3], "data_offsets": [32, 56]}}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * ((-len(raw) % 8) + 1)  # 8 + N is odd
    data = (a.numpy().tobytes() + c.view(torch.int16).numpy().tobytes()
            + b.numpy().tobytes())
    (tmp_path / "odd.safetensors").write_bytes(struct.pack("<Q", len(raw)) + raw + data)
    f = sio.SafeTensorsFile(tmp_path / "odd.safetensors")
    ref = st_load(str(tmp_path / "odd.safetensors"))
    for name, want in (("a", a), ("b", b), ("c", c)):
        offset, got = f.read(name, lambda t: (t.data_ptr() % t.element_size(), t.clone()))
        assert offset == 0
        assert torch.equal(got, want) and torch.equal(got, ref[name])


def test_atomic_replace_keeps_the_old_file_on_failure(tmp_path, monkeypatch):
    path = tmp_path / "model.safetensors"
    sio.save_file({"w": torch.ones(4)}, path)
    before = path.read_bytes()
    host_bytes = sio._host_bytes

    def failing(t):
        if t.numel() == 4:  # "w", written after "a"
            raise RuntimeError("device lost mid-write")
        return host_bytes(t)

    with monkeypatch.context() as m:
        m.setattr(sio, "_host_bytes", failing)
        with pytest.raises(RuntimeError, match="mid-write"):
            sio.save_file({"a": torch.zeros(8), "w": torch.full((4,), 3.0)}, path)
    assert path.read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == ["model.safetensors"]  # no temporary left
    sio.save_file({"w": torch.full((4,), 2.0)}, path)
    assert torch.equal(st_load(str(path))["w"], torch.full((4,), 2.0))


@pytest.mark.parametrize("odd", [False, True], ids=["aligned", "misaligned"])
def test_scoped_read_maps_one_tensor_for_its_use(tmp_path, odd):
    """``read(name, use)`` gives ``use`` the tensor from a map of its own
    bytes and unmaps it after; an offset not aligned to the element size
    reads through a copy there too."""
    w = _tensor(torch.float32, (256, 1024))
    if odd:
        header = {"v": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
                  "w": {"dtype": "F32", "shape": [256, 1024], "data_offsets": [3, 3 + w.numel() * 4]}}
        raw = json.dumps(header, separators=(",", ":")).encode()
        raw += b" " * (-len(raw) % 8)
        (tmp_path / "r.safetensors").write_bytes(struct.pack("<Q", len(raw)) + raw
                                                 + bytes([1, 2, 3]) + w.numpy().tobytes())
    else:
        sio.save_file({"w": w, "v": torch.arange(3, dtype=torch.uint8) + 1},
                      tmp_path / "r.safetensors")
    f = sio.SafeTensorsFile(tmp_path / "r.safetensors")
    seen = []
    assert f.read("w", lambda t: seen.append(t.data_ptr() % 4) or t.clone()).equal(w)
    assert seen == [0]
    assert f.read("v", lambda t: t.tolist()) == [1, 2, 3]
    assert torch.equal(f.read("w", torch.clone), w)


def test_read_keeps_the_error_of_use(tmp_path):
    """A ``use`` that raises leaves the view in its traceback's frames, so
    the map cannot close at once; the caller still gets ``use``'s own
    error, and the file reads on after it."""
    w = _tensor(torch.float32, (64, 64))
    sio.save_file({"w": w}, tmp_path / "e.safetensors")
    f = sio.SafeTensorsFile(tmp_path / "e.safetensors")

    def use(t):
        raise MemoryError(f"out of memory copying {tuple(t.shape)}")

    with pytest.raises(MemoryError, match="copying"):
        f.read("w", use)
    assert torch.equal(f.read("w", torch.clone), w)


def test_shards_sorted_and_later_wins(tmp_path):
    sio.save_file({"a": torch.zeros(2), "b": torch.ones(2)}, tmp_path / "m-00001.safetensors")
    sio.save_file({"b": torch.full((2,), 5.0)}, tmp_path / "m-00002.safetensors")
    index = sio.ShardIndex(tmp_path)
    assert len(index) == 2 and "a" in index
    assert torch.equal(index.read("b", lambda t: t.clone()), torch.full((2,), 5.0))
    with pytest.raises(FileNotFoundError, match="no .safetensors"):
        sio.ShardIndex(tmp_path / "missing")
