"""The port's Orbax reader and writer (utils/orbax_io.py) against Orbax
itself, through the JAX package's save_variables / restore_variables and
orbax-checkpoint and tensorstore directly. Every comparison is bit for
bit: the same dtype and the same bytes.

Covered: Orbax's default OCDBT + zstd layout and its per-leaf layout read
by the port; the port's checkpoints read by the JAX restore_variables,
with and without a template; a hypothesis test over the dtypes and shapes
the port handles; multi-chunk arrays with a missing chunk, written by
tensorstore into both layouts; the optax ``_state`` tree with its None
leaves; a flipped byte failing the CRC-32C; templates that do not fit; a
compressed frame with no libzstd; the committed fixture
tests/data/orbax_small (tools/make_orbax_fixture.py).
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from imageclust_tpu.utils.checkpoint import restore_variables as jax_restore
from imageclust_tpu.utils.checkpoint import save_variables as jax_save
from imageclust_tpu_torch.utils import orbax_io
from imageclust_tpu_torch.utils.checkpoint import (
    restore_variables,
    save_variables,
)

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "dense0": {"kernel": rng.normal(size=(37, 11)).astype(np.float32),
                       "bias": rng.normal(size=11).astype(np.float32)},
            "conv0": {"kernel": np.asarray(rng.normal(size=(3, 3, 2, 4)),
                                           jnp.bfloat16)},
        },
        "half": rng.normal(size=(5, 3)).astype(np.float16),
        "ids": rng.integers(-9, 9, (4, 6)).astype(np.int32),
        "big": rng.integers(0, 1 << 40, (300,)).astype(np.int64),
        "mask": rng.integers(0, 2, (7,)).astype(bool),
        "pixels": rng.integers(0, 256, (9, 9, 3)).astype(np.uint8),
        "epoch": np.asarray(5, np.int64),
    }


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _bits(x):
    """(dtype name, shape, bytes) of a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", tuple(x.shape), x.view(torch.uint16).numpy(
            ).tobytes()
        x = x.numpy()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def _assert_same(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys()
    for k in w:
        if w[k] is None:
            assert g[k] is None, k
        else:
            assert _bits(g[k]) == _bits(w[k]), k


class TestReadOrbax:
    def test_reads_jax_default_ocdbt_zstd(self, tmp_path):
        tree = _tree()
        jax_save(str(tmp_path / "ck"), tree)
        assert (tmp_path / "ck" / "manifest.ocdbt").exists()
        _assert_same(restore_variables(str(tmp_path / "ck")), tree)

    def test_reads_orbax_per_leaf_layout(self, tmp_path):
        tree = _tree(1)
        ck = ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False))
        ck.save(str(tmp_path / "ck"), tree, force=True)
        assert (tmp_path / "ck" / "params.dense0.kernel" / ".zarray").exists()
        _assert_same(restore_variables(str(tmp_path / "ck")), tree)

    def test_reads_committed_fixture(self):
        got = dict(_flat(restore_variables(str(DATA / "orbax_small"))))
        with np.load(DATA / "expected.npz") as z:
            want = dict(z)
        assert len(got) == len(want)
        for name, arr in want.items():
            key = name.removesuffix(".bf16bits").replace(".", "/")
            if name.endswith(".bf16bits"):
                assert got[key].dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got[key].view(torch.uint16).numpy(), arr)
            else:
                assert _bits(got[key]) == _bits(arr), name

    def test_fixture_needs_libzstd(self, monkeypatch):
        """The fixture's frames hold compressed blocks: without libzstd the
        read fails and names the file."""
        monkeypatch.setattr(orbax_io, "_libzstd", lambda: None)
        with pytest.raises(RuntimeError, match="orbax_small.*libzstd"):
            restore_variables(str(DATA / "orbax_small"))


class TestJaxReadsPort:
    @pytest.mark.parametrize("template", [False, True])
    def test_jax_restore_reads_port_checkpoint(self, tmp_path, template):
        tree = _tree(2)
        save_variables(str(tmp_path / "ck"), tree)
        meta = json.loads((tmp_path / "ck" / "_METADATA").read_text())
        assert meta["use_ocdbt"] is False
        back = jax_restore(str(tmp_path / "ck"), tree if template else None)
        _assert_same(jax.tree.map(np.asarray, back), tree)

    def test_port_round_trip_and_replace(self, tmp_path):
        path = str(tmp_path / "ck")
        save_variables(path, _tree(3))
        tree = _tree(4)
        save_variables(path, tree)  # replaces, as Orbax's force=True
        _assert_same(restore_variables(path), tree)
        assert os.listdir(tmp_path) == ["ck"]

    def test_tensors_and_template_dtypes(self, tmp_path):
        tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}
        save_variables(str(tmp_path / "ck"), tree)
        back = restore_variables(str(tmp_path / "ck"), tree)
        assert isinstance(back["w"], torch.Tensor)
        assert torch.equal(back["w"], tree["w"])
        assert torch.equal(back["b"], tree["b"])
        as_np = restore_variables(str(tmp_path / "ck"),
                                  {"w": np.zeros((2, 3), np.int64),
                                   "b": np.zeros(2, np.float32)})
        assert as_np["w"].dtype == np.int64
        np.testing.assert_array_equal(as_np["b"], [1.5, -2.0])


_DTYPES = [np.float32, np.float16, np.int32, np.int64, np.bool_, np.uint8,
           "bfloat16"]


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    shape = tuple(draw(st.lists(st.integers(1, 5), min_size=0, max_size=3)))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, int(np.prod(shape, dtype=np.int64)) * 8,
                       dtype=np.uint8)
    if dtype == "bfloat16":
        bits = raw.view(np.uint16)[:int(np.prod(shape, dtype=np.int64))]
        return torch.from_numpy(bits.reshape(shape).copy()).view(
            torch.bfloat16)
    if dtype == np.bool_:
        return (raw[:int(np.prod(shape, dtype=np.int64))] & 1).astype(
            bool).reshape(shape)
    dt = np.dtype(dtype)
    return raw.view(dt)[:int(np.prod(shape, dtype=np.int64))].reshape(shape)


class TestHypothesis:
    @settings(max_examples=40, deadline=None)
    @given(leaves=st.lists(_arrays(), min_size=1, max_size=4))
    def test_round_trip_bits(self, tmp_path_factory, leaves):
        path = str(tmp_path_factory.mktemp("h") / "ck")
        tree = {"a": {f"x{i}": v for i, v in enumerate(leaves)}}
        save_variables(path, tree)
        _assert_same(restore_variables(path), tree)
        meta = json.loads(Path(path, "a.x0", ".zarray").read_text())
        assert meta["shape"] == list(leaves[0].shape)


def _ts_write(kvstore, path, arr, chunks, skip=()):
    """Write ``arr`` as a zarr v2 array with tensorstore, zstd-compressed,
    leaving out the chunks whose index is in ``skip``."""
    dt = {np.float32: "<f4", np.int32: "<i4"}[arr.dtype.type]
    t = ts.open({"driver": "zarr", "kvstore": kvstore,
                 "metadata": {"shape": list(arr.shape), "chunks": list(chunks),
                              "dtype": dt, "fill_value": None,
                              "compressor": {"id": "zstd", "level": 1}},
                 "create": True}).result()
    grid = [range(-(-s // c)) for s, c in zip(arr.shape, chunks)]
    import itertools

    for idx in itertools.product(*grid):
        if idx in skip:
            continue
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, arr.shape))
        t[sl] = arr[sl]


def _meta(path, names, ocdbt):
    leaves = {str((n,)): {"key_metadata": [{"key": n, "key_type": 2}],
                          "value_metadata": {"value_type": "np.ndarray",
                                             "skip_deserialize": False}}
              for n in names}
    Path(path, "_METADATA").write_text(json.dumps(
        {"tree_metadata": leaves, "use_ocdbt": ocdbt, "use_zarr3": False}))


class TestMultiChunk:
    @pytest.mark.parametrize("ocdbt", [False, True])
    def test_chunk_grid_and_missing_chunk(self, tmp_path, ocdbt):
        rng = np.random.default_rng(5)
        # chunks of 1280 bytes: over OCDBT's 1 KiB inline limit, so one
        # B-tree leaf holds several data-file references
        a = rng.normal(size=(70, 45)).astype(np.float32)
        b = rng.integers(-5, 5, (10,)).astype(np.int32)
        root = tmp_path / "ck"
        root.mkdir()
        for name, arr, chunks, skip in (("a", a, (16, 20), {(1, 2)}),
                                        ("b", b, (4,), ())):
            base = {"driver": "file", "path": f"{root}/{name}/"}
            if ocdbt:
                base = {"driver": "ocdbt", "base": f"file://{root}/",
                        "path": f"{name}/"}
            _ts_write(base, None, arr, chunks, skip)
        _meta(root, ["a", "b"], ocdbt)
        got = restore_variables(str(root))
        want_a = a.copy()
        want_a[16:32, 40:45] = 0.0  # fill_value null reads as zeros
        np.testing.assert_array_equal(got["a"], want_a)
        np.testing.assert_array_equal(got["b"], b)
        assert (root / "manifest.ocdbt").exists() == ocdbt


class TestStateTree:
    def _state(self):
        params = {"dense0": {"kernel": np.full((3, 2), 0.5, np.float32)}}
        opt = optax.adamw(1e-3).init(params)
        return {"variables": {"params": params},
                "opt_state": jax.tree.map(np.asarray, opt),
                "epoch": np.asarray(2, np.int64)}

    def test_jax_state_reads_with_none_leaves(self, tmp_path):
        jax_save(str(tmp_path / "ck"), self._state())
        got = restore_variables(str(tmp_path / "ck"))
        assert got["opt_state"][1] is None and got["opt_state"][2] is None
        assert got["opt_state"][0]["count"].dtype == np.int32
        port_tpl = {"variables": {"params": {"dense0": {
            "kernel": np.zeros((3, 2), np.float32)}}},
            "opt_state": ({"count": np.zeros((), np.int32),
                           "mu": {"dense0": {"kernel": np.zeros((3, 2),
                                                                np.float32)}},
                           "nu": {"dense0": {"kernel": np.zeros((3, 2),
                                                                np.float32)}}},
                          None, None),
            "epoch": np.zeros((), np.int64)}
        got = restore_variables(str(tmp_path / "ck"), port_tpl)
        assert isinstance(got["opt_state"], tuple)
        assert int(got["epoch"]) == 2

    def test_port_state_restores_in_jax(self, tmp_path):
        want = self._state()
        adam = want["opt_state"][0]
        port_state = dict(want, opt_state=(
            {"count": adam.count, "mu": adam.mu, "nu": adam.nu}, None, None))
        save_variables(str(tmp_path / "ck"), port_state)
        meta = json.loads((tmp_path / "ck" / "_METADATA").read_text())
        none = meta["tree_metadata"]["('opt_state', '1')"]
        assert none["value_metadata"] == {"value_type": "None",
                                          "skip_deserialize": True}
        assert none["key_metadata"][1] == {"key": "1", "key_type": 1}
        back = jax_restore(str(tmp_path / "ck"), want)
        assert int(back["opt_state"][0].count) == int(adam.count)
        np.testing.assert_array_equal(
            back["variables"]["params"]["dense0"]["kernel"],
            want["variables"]["params"]["dense0"]["kernel"])


class TestFaults:
    def test_flipped_byte_fails_crc(self, tmp_path):
        jax_save(str(tmp_path / "ck"), _tree(6))
        manifest = tmp_path / "ck" / "manifest.ocdbt"
        data = bytearray(manifest.read_bytes())
        data[20] ^= 0x40
        manifest.write_bytes(bytes(data))
        with pytest.raises(ValueError, match="CRC-32C"):
            restore_variables(str(tmp_path / "ck"))

    def test_wrong_shape_names_leaf(self, tmp_path):
        tree = _tree(7)
        save_variables(str(tmp_path / "ck"), tree)
        bad = jax.tree.map(lambda x: x, tree)
        bad["params"]["dense0"]["bias"] = np.zeros(12, np.float32)
        with pytest.raises(ValueError, match="params/dense0/bias: shape"):
            restore_variables(str(tmp_path / "ck"), bad)

    def test_missing_leaf_names_leaf(self, tmp_path):
        save_variables(str(tmp_path / "ck"), {"a": np.zeros(2, np.float32)})
        with pytest.raises(ValueError, match="no leaf b/c"):
            restore_variables(str(tmp_path / "ck"),
                              {"a": np.zeros(2, np.float32),
                               "b": {"c": np.zeros(1, np.float32)}})

    def test_compressed_frame_without_libzstd(self, tmp_path, monkeypatch):
        jax_save(str(tmp_path / "ck"), _tree(8))
        monkeypatch.setattr(orbax_io, "_libzstd", lambda: None)
        with pytest.raises(RuntimeError,
                           match=f"{tmp_path}.*no libzstd found"):
            restore_variables(str(tmp_path / "ck"))

    def test_unsupported_dtype_raises(self, tmp_path):
        with pytest.raises(ValueError, match="float64"):
            save_variables(str(tmp_path / "ck"), {"x": np.zeros(2)})
        assert not os.path.exists(tmp_path / "ck")
        assert os.listdir(tmp_path) == []


class TestCodecs:
    def test_crc32c_check_value(self):
        assert orbax_io.crc32c(b"123456789") == 0xE3069283
        assert orbax_io.crc32c(b"") == 0

    @pytest.mark.parametrize("n", [0, 1, 1000, (1 << 17) + 5])
    def test_raw_frames_decode_in_python_and_libzstd(self, n):
        data = np.random.default_rng(n).integers(0, 256, n,
                                                 dtype=np.uint8).tobytes()
        frame = orbax_io.zstd_encode_raw(data)
        assert orbax_io._frames_python(frame) == data
        lib = orbax_io._libzstd()
        if lib is None:
            pytest.skip("no system libzstd to cross-check against")
        assert orbax_io._frames_libzstd(lib, frame) == data

    def test_rle_block_decodes_in_python(self):
        # frame header (single segment, 1-byte size 7), one last RLE block
        frame = b"\x28\xb5\x2f\xfd\x20\x07" + (
            1 | (1 << 1) | (7 << 3)).to_bytes(3, "little") + b"z"
        assert orbax_io.zstd_decode(frame) == b"z" * 7

