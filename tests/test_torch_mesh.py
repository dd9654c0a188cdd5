"""The port's mesh (core/mesh.py), its collectives (core/collectives.py)
and its process launcher (parallel/), on the CPU over gloo.

``create_mesh`` runs in this process as a world of one rank; the
collectives and the launcher run in fresh interpreters (two and four
ranks, one launch per world, each under a timeout of its own). Every
check is exact: the collectives move and add small integers.
"""

import numpy as np
import pytest
import torch

import imageclust_tpu_torch.parallel as par
from imageclust_tpu_torch.core import collectives as cc
from imageclust_tpu_torch.core.mesh import (
    Mesh,
    ShardedRows,
    axis_size,
    check_mesh,
    create_mesh,
    gather_rows,
    init_distributed,
    local_rows,
    local_stream,
    owned_rows,
    row_block,
    rows_per,
)

import test_torch_mesh_targets as targets

torch.set_num_threads(1)


class TestCreateMesh:
    def test_world_of_one(self):
        m = create_mesh(device="cpu")
        assert m.shape == {"data": 1, "model": 1}
        assert axis_size(m, "data") == 1 and axis_size(m, "model") == 1
        assert m.rank == 0 and m.coords == (0, 0) and m.size == 1
        assert m.device == torch.device("cpu") and m.backend == "gloo"
        assert m.groups == {"data": None, "model": None}
        assert create_mesh(data=1, model=1, device="cpu").shape["data"] == 1

    @pytest.mark.parametrize("data,model,match", [
        (2, 1, "needs 2 ranks, have 1"), (1, 2, "needs 2 ranks, have 1"),
        (-1, 2, "not divisible by model=2"), (4, 2, "needs 8 ranks")])
    def test_too_few_devices_raises(self, data, model, match):
        """Where the JAX create_mesh moves to host CPU devices, the port
        raises."""
        with pytest.raises(ValueError, match=match):
            create_mesh(data=data, model=model, device="cpu")

    def test_device_errors(self, monkeypatch):
        with pytest.raises(ValueError, match="unsupported mesh device"):
            create_mesh(device="tpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            create_mesh()  # the default device is the card

    def test_check_mesh(self):
        m = create_mesh(device="cpu")
        assert check_mesh(m) is m and check_mesh(None) is None
        with pytest.raises(TypeError, match="Mesh"):
            check_mesh(object())

    def test_init_distributed_noop_in_one_process(self, monkeypatch):
        monkeypatch.delenv("RANK", raising=False)
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert init_distributed() is False

    def test_parallel_reexports(self):
        for name in ("create_mesh", "init_distributed", "axis_size",
                     "local_rows", "gather_rows", "make_train_step",
                     "param_spec", "shard_variables", "launch_processes"):
            assert callable(getattr(par, name)), name
        assert par.create_mesh is create_mesh


def _fake(data, rank):
    """A Mesh object at ``rank`` of ``data`` ranks, for the row arithmetic
    (no collective runs)."""
    return Mesh(data, 1, rank, torch.device("cpu"), "gloo", {})


class TestRowBlocks:
    @pytest.mark.parametrize("n,data", [(10, 1), (10, 3), (12, 4), (5, 8)])
    def test_blocks_cover_the_rows(self, n, data):
        x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        rp = rows_per(n, _fake(data, 0))
        assert rp == -(-n // data)
        seen = []
        for r in range(data):
            blk = local_rows(x, _fake(data, r))
            assert blk.local.shape == (rp, 2) and blk.shape == (n, 2)
            assert blk.row0 == r * rp
            seen.append(blk.local[:blk.n_local].numpy())
            assert not blk.local[blk.n_local:].any()  # zero padding
        np.testing.assert_array_equal(np.concatenate(seen), x)

    @pytest.mark.parametrize("n,data", [(10, 3), (12, 4), (5, 8)])
    def test_row_block_and_owned_rows(self, n, data):
        rp = -(-n // data)
        for r in range(data):
            m = _fake(data, r)
            row0, n_local = row_block(n, m)
            assert row0 == r * rp
            assert n_local == len(range(n)[r * rp:(r + 1) * rp])
            assert local_rows(np.zeros((n, 1)), m).n_local == n_local
            idx = torch.arange(n)
            li, own = owned_rows(idx, row0, rp)
            np.testing.assert_array_equal(
                own.numpy(), (idx >= row0).numpy() & (idx < row0 + rp).numpy())
            assert int(li.min()) >= 0 and int(li.max()) < rp
            np.testing.assert_array_equal(li[own].numpy(),
                                          np.arange(int(own.sum())))

    def test_pad_and_take_in_a_world_of_one(self):
        m = create_mesh(device="cpu")
        real = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        blk = ShardedRows.pad(real, 3, m)
        assert torch.equal(blk.local, real)
        assert torch.equal(blk.take(torch.tensor([2, 0])), real[[2, 0]])
        fm = _fake(2, 1)  # rows_per(3) = 2; rank 1 holds 1 real row
        pad = ShardedRows.pad(real[2:], 3, fm)
        assert pad.local.shape == (2, 2) and pad.n_local == 1
        assert not pad.local[1].any()

    def test_gather_in_a_world_of_one(self):
        m = create_mesh(device="cpu")
        x = np.arange(12, dtype=np.float32).reshape(6, 2)
        blk = local_rows(x, m)
        np.testing.assert_array_equal(gather_rows(blk), x)
        assert blk.map(lambda t: t * 2).local.sum() == 2 * x.sum()
        with pytest.raises(ValueError, match="rows"):
            ShardedRows(torch.zeros(3, 2), 6, m)

    @pytest.mark.parametrize("n,data,sizes", [
        (10, 2, [4, 4, 2]), (10, 3, [3, 3, 3, 1]), (7, 4, [7])])
    def test_local_stream(self, n, data, sizes):
        rows = np.arange(n)
        chunks = np.split(rows, np.cumsum(sizes)[:-1])
        got = [np.concatenate(list(local_stream(iter(chunks), n,
                                                _fake(data, r))) or [[]])
               for r in range(data)]
        np.testing.assert_array_equal(np.concatenate(got), rows)
        rp = -(-n // data)
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g, rows[r * rp:(r + 1) * rp])


class TestCollectivesInOneProcess:
    def test_identity_with_counts(self):
        m = create_mesh(device="cpu")
        cc.COUNTERS.reset()
        x = torch.arange(4, dtype=torch.float32)
        assert torch.equal(cc.psum(x, m), x)
        assert torch.equal(cc.all_gather_rows(x, m), x)
        assert torch.equal(cc.all_to_all_rows(x[None], m), x[None])
        d, i = cc.pmin_pair(x, x.long(), m)
        assert torch.equal(d, x) and torch.equal(i, x.long())
        assert cc.gather_objects("a", m) == ["a"]
        assert cc.broadcast_object("b", m) == "b"
        assert torch.equal(cc.pmax(x, m), x)
        assert cc.on_rank(lambda: "c", m) == "c"
        with pytest.raises(ValueError, match="down"):
            cc.on_rank(lambda: (_ for _ in ()).throw(ValueError("down")), m)
        snap = cc.COUNTERS.snapshot()
        assert snap["calls"] == {"psum": 1, "all_gather": 1,
                                 "all_to_all": 1, "pmin_pair": 1,
                                 "gather_objects": 1, "pmax": 1,
                                 "broadcast_object": 3}
        assert snap["bytes"]["psum"] == 16 and snap["seconds"] == 0.0
        with pytest.raises(ValueError, match="dim 0"):
            cc.all_to_all_rows(x, m)


# the launcher's own bodies (parallel/_worker.py), run inside each world's
# launch after its collectives: every launch starts a fresh interpreter a
# rank, so one launch a world keeps the tests' CPU down
_VERIFY = {2: ("verify_all", (2, 1)), 4: ("verify_psum", (4, 1))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every collective wrapper over 2 ranks (data=2) and 4 ranks (data=2 x
    model=2, and data=4), then the world's ``verify_*`` body: one launch
    per world. ``worlds["logs"][ranks]`` holds each rank's log."""
    out = {"logs": {}}
    for ranks, specs in ((2, [(2, 1)]), (4, [(2, 2), (4, 1)])):
        cases = [(f"{kind}{d}x{m}", f"case_{name}", (d, m), {})
                 for d, m in specs
                 for kind, name in (("c", "collectives"), ("r", "rows"))]
        fn, spec = _VERIFY[ranks]
        cases.append(("verify", "case_verify", spec, {"fn": fn}))
        logs = out["logs"][ranks] = []
        out[ranks] = targets.run(cases, ranks,
                                 tmp_path_factory.mktemp(f"w{ranks}"),
                                 logs=logs)
    return out


@pytest.mark.parametrize("ranks,data,model", [(2, 2, 1), (4, 2, 2),
                                              (4, 4, 1)])
class TestCollectives:
    def _outs(self, worlds, ranks, data, model):
        return [w[f"c{data}x{model}"] for w in worlds[ranks]]

    def test_coords(self, worlds, ranks, data, model):
        for r, w in enumerate(self._outs(worlds, ranks, data, model)):
            assert w["out"]["coords"] == divmod(r, model)

    def test_psum(self, worlds, ranks, data, model):
        base = np.arange(3, dtype=np.float32)
        for r, w in enumerate(self._outs(worlds, ranks, data, model)):
            o = w["out"]
            dm, mm = divmod(r, model)
            data_ranks = [d * model + mm for d in range(data)]
            model_ranks = [dm * model + m for m in range(model)]
            np.testing.assert_array_equal(
                o["psum_data"], sum(base + 10 * q for q in data_ranks))
            np.testing.assert_array_equal(
                o["psum_model"], sum(base + 10 * q for q in model_ranks))
            np.testing.assert_array_equal(
                o["psum_world"], sum(base + 10 * q for q in range(ranks)))

    def test_all_gather_and_all_to_all(self, worlds, ranks, data, model):
        for r, w in enumerate(self._outs(worlds, ranks, data, model)):
            o = w["out"]
            mm = r % model
            data_ranks = [d * model + mm for d in range(data)]
            np.testing.assert_array_equal(
                o["gather"], np.stack([np.arange(3) + 10 * q
                                       for q in data_ranks]))
            # block j of the result came from data rank j, and was the
            # block that rank addressed to this one
            me = r // model
            np.testing.assert_array_equal(
                o["all_to_all"][:, 0], [100 * q + me for q in data_ranks])

    def test_pmin_pair_keeps_first_index(self, worlds, ranks, data, model):
        """Element 0: every rank holds distance 1.0, and the smallest index
        wins; element 1: the last data rank's distance is the smallest;
        element 2: all inf, the smallest index."""
        for r, w in enumerate(self._outs(worlds, ranks, data, model)):
            d, i = w["out"]["pmin"]
            mm = r % model
            data_ranks = [q * model + mm for q in range(data)]
            last = data_ranks[-1]
            np.testing.assert_array_equal(d[:2], [1.0, 5.0 - last])
            assert np.isinf(d[2])
            np.testing.assert_array_equal(
                i, [7 - last, 50 + last, 90 + data_ranks[0]])

    def test_broadcast_and_objects(self, worlds, ranks, data, model):
        for r, w in enumerate(self._outs(worlds, ranks, data, model)):
            o = w["out"]
            np.testing.assert_array_equal(o["bcast"], [float(ranks)])
            mm = r % model
            assert o["objects"] == [{"r": q * model + mm}
                                    for q in range(data)]

    def test_take_pmax_and_on_rank(self, worlds, ranks, data, model):
        """ShardedRows.take returns global rows on every rank in the
        array's dtype (int8 summed in float32 across ranks); pmax is the
        elementwise max over ``data``; on_rank hands the last rank's
        result to every rank."""
        host = np.arange(14, dtype=np.float32).reshape(7, 2) - 5
        idx = [6, 0, 3, 3]
        for r, w in enumerate(worlds[ranks]):
            o = w[f"r{data}x{model}"]["out"]
            np.testing.assert_array_equal(o["take"], host[idx])
            assert o["take_int8"].dtype == np.int8
            np.testing.assert_array_equal(o["take_int8"], host[idx])
            mm = r % model
            data_ranks = [q * model + mm for q in range(data)]
            np.testing.assert_array_equal(
                o["pmax"], [max(data_ranks), -min(data_ranks)])
            assert o["on_rank"] == {"from": ranks - 1}

    def test_rank_keeps_single_card_precision(self, worlds, ranks, data,
                                              model):
        """create_mesh resolves the rank's device as resolve_device does:
        TF32 off for matmuls and cuDNN convolutions, bf16 products reduced
        in float32 (torch's default leaves cuDNN's TF32 on)."""
        for w in self._outs(worlds, ranks, data, model):
            assert w["out"]["strict_f32"] == {
                "cudnn_tf32": False, "matmul_tf32": False,
                "bf16_reduced": False}

    def test_counters(self, worlds, ranks, data, model):
        for w in self._outs(worlds, ranks, data, model):
            snap = w["counters"]
            assert snap["calls"]["psum"] == 3
            assert snap["bytes"]["psum"] == 3 * 12
            assert snap["bytes"]["all_to_all"] == data * 2 * 4
            assert snap["bytes"]["pmin_pair"] == 3 * 16
            assert snap["seconds"] > 0.0  # time inside the collectives


class TestLauncher:
    def test_reports_worker_failure(self):
        with pytest.raises(RuntimeError) as err:
            par.launch_processes(
                "imageclust_tpu_torch.parallel._worker:_fail", 2,
                timeout=60.0)
        msg = str(err.value)
        assert "intentional worker failure" in msg
        assert "worker 0: rc=1" in msg and "worker 1: rc=1" in msg

    def test_timeout_kills_every_worker(self):
        with pytest.raises(RuntimeError, match="TIMEOUT after 6.0s"):
            par.launch_processes("tests.test_torch_mesh_targets:hang", 2,
                                 timeout=6.0)

    def test_refuses_a_missing_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            par.launch_processes("x:y", 1, device="cuda")
        with pytest.raises(ValueError, match="unsupported device"):
            par.launch_processes("x:y", 1, device="tpu")

    def test_psum_train_step_and_bucketed_over_two_ranks(self, worlds):
        """The counterpart of tests/test_multiprocess.py: two ranks
        exchange real collectives (the workers assert on the global
        results), in the two-rank world's launch."""
        assert len(worlds[2]) == len(worlds["logs"][2]) == 2
        for w, log in zip(worlds[2], worlds["logs"][2]):
            for line in ("psum ok", "train step ok", "bucketed ok"):
                assert line in w["verify"]["out"]
            assert par.OK_SENTINEL in log

    def test_psum_over_four_ranks(self, worlds):
        assert all("psum ok: 6.0 over 4 ranks" in w["verify"]["out"]
                   for w in worlds[4])
        assert all(par.OK_SENTINEL in log for log in worlds["logs"][4])
