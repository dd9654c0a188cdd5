"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is False. On a GPU host
without JAX (tests/conftest.py imports it) run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch

from imageclust_tpu_torch.cluster import ward
from imageclust_tpu_torch.ops import merge_kernels as mk

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from imageclust_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _state(gen, n, dev, tied):
    d = (torch.randint(0, 4, (n, n), generator=gen).float() if tied
         else torch.rand((n, n), generator=gen))
    d = ((d + d.T) / 2).contiguous()
    d.fill_diagonal_(0.0)
    births = torch.randperm(2 * n, generator=gen)[:n].to(torch.int32)
    sizes = torch.randint(1, 4, (n,), generator=gen).to(torch.int32)
    active = (torch.rand(n, generator=gen) < 0.8).to(torch.int32)
    dvec = torch.rand(n, generator=gen)
    return [t.to(dev) for t in (d, dvec, births, sizes, active)]


@pytest.mark.parametrize("n", [128, 384, 2048])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("do_update", [0, 1])
def test_kernel_bit_identical_to_twin(cuda, n, tied, do_update):
    gen = torch.Generator().manual_seed(n + tied)
    D, dvec, births, sizes, active = _state(gen, n, cuda, tied)
    for sa in (0, n // 3, n - 1):
        for max_size in (0, 3, 6):
            dk, dp = D.clone(), D.clone()
            before = mk.launches
            got = mk.merge_update_argmin(dk, dvec, sa, do_update, births,
                                         sizes, active, max_size)
            assert mk.launches == before + 1
            want = mk.merge_update_argmin_plain(dp, dvec, sa, do_update,
                                                births, sizes, active,
                                                max_size)
            assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
            assert [float(v) for v in got[1:]] == [float(v)
                                                   for v in want[1:]]


def test_kernel_rejects_cpu_scalars_on_cuda(cuda):
    D = torch.zeros((128, 128), device=cuda)
    v = torch.zeros(128, device=cuda)
    i = torch.zeros(128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        mk.merge_update_argmin(D, v, torch.zeros(1, dtype=torch.int32), 0,
                               i, i, i, 6)


def _batched_state(gen, C, B, dev, tied):
    d = (torch.randint(0, 4, (C, B, B), generator=gen).float() if tied
         else torch.rand((C, B, B), generator=gen))
    d = ((d + d.transpose(1, 2)) / 2).contiguous()
    births = torch.stack([torch.randperm(2 * B, generator=gen)[:B]
                          for _ in range(C)]).to(torch.int32)
    sizes = torch.randint(1, 4, (C, B), generator=gen).to(torch.int32)
    active = (torch.rand((C, B), generator=gen) < 0.8).to(torch.int32)
    active[0] = 0  # bucket 0: every pair infeasible
    dvec = torch.rand((C, B), generator=gen)
    sa = torch.randint(0, B, (C,), generator=gen).to(torch.int32)
    do = torch.randint(0, 2, (C,), generator=gen).to(torch.int32)
    return [t.to(dev) for t in (d, dvec, sa, do, births, sizes, active)]


@pytest.mark.parametrize("C,B", [(1, 128), (8, 512), (261, 128), (3, 200)])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("absorb_min", [-1, 3])
def test_batched_kernel_bit_identical_to_twin(cuda, C, B, tied, absorb_min):
    gen = torch.Generator().manual_seed(C * B + tied)
    D, dvec, sa, do, births, sizes, active = _batched_state(gen, C, B, cuda,
                                                            tied)
    for max_size in (0, 6):
        dk, dp = D.clone(), D.clone()
        before = mk.batched_launches
        got = mk.merge_update_argmin_batched(dk, dvec, sa, do, births, sizes,
                                             active, max_size, absorb_min)
        assert mk.batched_launches == before + 1
        want = mk.merge_update_argmin_batched_plain(
            dp, dvec, sa, do, births, sizes, active, max_size, absorb_min)
        assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.isinf(got[1][0])  # the all-infeasible bucket


def _lockstep_inputs(dev, C, B, data, counts=None, d=16, seed=0):
    """(features, bucket index, counts, targets) of one lockstep chunk on
    ``dev``: counts 0.75 B, 37, 5 and 0 in turn unless given; "grid_d2"
    gives heavy ties."""
    from imageclust_tpu_torch.cluster import sharded

    rng = np.random.default_rng(seed + C + B)
    if data == "normal":
        x = rng.normal(size=(C * B, d))
    else:
        x = rng.integers(-3, 4, (C * B, 2 if data == "grid_d2" else d))
    if counts is None:
        counts = np.resize([int(0.75 * B), 37, 5, 0], C)
    counts = np.minimum(np.asarray(counts, np.int32), B)
    targets = np.array([sharded._bucket_target(int(c), 3, 6) if c else 0
                        for c in counts], np.int32)
    bidx = np.arange(C * B, dtype=np.int32).reshape(C, B)
    return [torch.from_numpy(np.asarray(a)).to(dev) for a in (
        x.astype(np.float32), bidx, counts, targets)]


def _same_lockstep(a, b):
    for name in ("D", "births", "sizes", "active", "dvec", "log", "pair",
                 "pair_f", "proceed", "out_d", "out_pair"):
        ta, tb = getattr(a, name), getattr(b, name)
        if ta.dtype == torch.float32:
            ta, tb = ta.view(torch.int32), tb.view(torch.int32)
        assert torch.equal(ta, tb), name
    assert torch.equal(a.ctl[:, :mk.LCTL_TICKET + 1],
                       b.ctl[:, :mk.LCTL_TICKET + 1])
    assert torch.equal(a.flags[:mk.LFLAG_TICKET + 1],
                       b.flags[:mk.LFLAG_TICKET + 1])


@pytest.mark.parametrize("C,B,counts", [(4, 128, None), (8, 512, None),
                                        (3, 200, (200, 150, 7)),
                                        (2, 33, (33, 0))])
@pytest.mark.parametrize("data", ["normal", "grid", "grid_d2"])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_lockstep_steps_bit_identical_to_twin(cuda, C, B, counts, data,
                                              rule):
    """K3's loop calls (the per-bucket cache, the fused bookkeeping) against
    the twin step on a copy of the state, after every iteration of both
    phases and a few gated no-op iterations past each phase's end."""
    from imageclust_tpu_torch.cluster import sharded

    args = _lockstep_inputs(cuda, C, B, data, counts)
    (st_k, c_k), (st_p, c_p) = (sharded._lockstep_state(*args)
                                for _ in range(2))
    for amin in (-1, 3):
        st_k.begin_phase(amin)
        st_p.begin_phase(amin)
        for k in range(B + 4):
            before = mk.batched_launches
            mk.lockstep_step(st_k, 6)
            assert mk.batched_launches == before + 1
            mk.lockstep_step_plain(st_p, 6)
            _same_lockstep(st_k, st_p)
            sharded._lockstep_float(st_k, c_k, rule)
            sharded._lockstep_float(st_p, c_p, rule)
            if k > 2 and not int(st_k.flags[mk.LFLAG_ANY_RAN]):
                break
        assert not int(st_k.flags[mk.LFLAG_ANY_RAN])
    assert int(st_k.ctl[:, mk.LCTL_STEP].sum()) > 0
    assert int(st_k.ctl[:, mk.LCTL_CACHED_CALLS].sum()) > 0


@pytest.mark.parametrize("C,B", [(8, 512), (5, 200), (64, 128)])
@pytest.mark.parametrize("data", ["normal", "grid_d2"])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_graphed_lockstep_chunk_matches_eager_twin(cuda, monkeypatch, C, B,
                                                   data, rule):
    """``_bucket_chunk_fused`` on the card (K3 in CUDA graph replays)
    against the eager twin loop; each phase launches K3 between its
    iterations + 1 and its iterations + FOUND_READ_EVERY times."""
    from imageclust_tpu_torch.cluster import sharded

    args = _lockstep_inputs(cuda, C, B, data)
    it0, ph0, k3 = (sharded.lockstep_iterations, sharded.lockstep_phases,
                    mk.batched_launches)
    got = sharded._bucket_chunk_fused(*args, 6, 3, rule)
    iters = sharded.lockstep_iterations - it0
    phases = sharded.lockstep_phases - ph0
    launches = mk.batched_launches - k3
    assert phases == 2 and iters > 0
    assert iters + phases <= launches <= (
        iters + ward.FOUND_READ_EVERY * phases)
    monkeypatch.setattr(sharded, "lockstep_step", mk.lockstep_step_plain)
    k3 = mk.batched_launches
    want = sharded._bucket_chunk_fused(*args, 6, 3, rule)
    assert mk.batched_launches == k3  # the twin launches nothing
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (C, B, counts (None: 0.75 B, 37, 5, 0 in turn), max_size)
_WHOLE_CASES = [(3, 128, None, 6), (64, 512, None, 6), (5, 200, None, 6),
                (4, 2, (0, 1, 2, 2), 6), (4, 33, (0, 1, 2, 33), 6),
                (2, 4096, (4096, 3000), 6),
                (3, 128, None, 2)]  # max_size 2: a merged slot is blocked


@pytest.mark.parametrize("C,B,counts,max_size", _WHOLE_CASES)
@pytest.mark.parametrize("data", ["normal", "grid", "grid_d2"])
@pytest.mark.parametrize("absorb_min", [0, 3])
def test_whole_loop_kernel_bit_identical_to_twin(cuda, C, B, counts,
                                                 max_size, data, absorb_min):
    """K2 against its twin: the five outputs and D's final bits. The d = 2
    integer grid gives heavy ties (many rows cache the same column)."""
    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import bucket_kernels as bk

    rng = np.random.default_rng(C + B)
    if data == "normal":
        x = rng.normal(size=(C, B, 16))
    else:
        x = rng.integers(-3, 4, (C, B, 2 if data == "grid_d2" else 16))
    if counts is None:
        counts = np.resize([int(0.75 * B), 37, 5, 0], C)
    counts = np.asarray(counts, np.int32)
    targets = np.array([sharded._bucket_target(int(c), 3, 6) if c else 0
                        for c in counts], np.int32)
    D = sharded.pairwise_ward_singleton(
        torch.from_numpy(x.astype(np.float32)).to(cuda))
    ct = torch.from_numpy(counts).to(cuda)
    tg = torch.from_numpy(targets).to(cuda)
    dk, dp = D.clone(), D.clone()
    before = bk.launches
    got = bk.merge_loop_whole(dk, ct, tg, max_size, absorb_min)
    assert bk.launches == before + 1
    want = bk.merge_loop_whole_plain(dp, ct, tg, max_size, absorb_min)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(dk.view(torch.int32), dp.view(torch.int32))
    assert int(got[1].sum()) > 0


def _features(data, n, seed):
    rng = np.random.default_rng(seed)
    if data == "normal":
        return rng.normal(size=(n, 16)).astype(np.float32)
    d = 2 if data == "grid_d2" else 64
    return rng.integers(-2, 3, (n, d)).astype(np.float32)


def _same_state(a, b):
    for name in ("D", "births", "sizes", "active", "dvec", "log", "pair",
                 "pair_f", "found", "out_d", "out_pair"):
        ta, tb = getattr(a, name), getattr(b, name)
        if ta.dtype == torch.float32:
            ta, tb = ta.view(torch.int32), tb.view(torch.int32)
        assert torch.equal(ta, tb), name
    assert torch.equal(a.ctl[:mk.CTL_FILLED + 1], b.ctl[:mk.CTL_FILLED + 1])


@pytest.mark.parametrize("n,data,max_size", [
    (100, "normal", 6), (1000, "normal", 6), (1000, "grid", 6),
    (700, "grid_d2", 6), (300, "grid_d2", 2)])
@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
def test_cached_steps_bit_identical_to_twin_and_stateless(cuda, n, data,
                                                          max_size, rule):
    """K1's loop steps (the cache, the fused bookkeeping) against the twin
    step on a copy of the state, every step and past the step limit, and
    each step's pair against a stateless K1 call on the same inputs."""
    x = _features(data, n, n + max_size)
    xp = torch.zeros((ward._pad_len(n), x.shape[1]))
    xp[:n] = torch.from_numpy(x)
    xp = xp.to(cuda)
    limit = n - ward.calculate_optimal_clusters(n, min(3, max_size),
                                                max_size)
    st_k, c_k = ward._loop_state(xp, n, limit, max_size)
    st_p, c_p = ward._loop_state(xp, n, limit, max_size)
    for _ in range(limit + 3):
        sl = mk.merge_update_argmin(
            st_k.D.clone(), st_k.dvec, st_k.ctl[mk.CTL_SA:mk.CTL_SA + 1],
            st_k.ctl[mk.CTL_DO:mk.CTL_DO + 1], st_k.births, st_k.sizes,
            st_k.active, max_size)
        before = mk.launches
        mk.merge_step(st_k)
        assert mk.launches == before + 1
        mk.merge_step_plain(st_p)
        _same_state(st_k, st_p)
        assert torch.equal(sl[1].view(torch.int32),
                           st_k.out_d[0].view(torch.int32))
        assert torch.equal(torch.stack(sl[2:]), st_k.out_pair)
        ward._float_step(st_k, c_k, rule)
        ward._float_step(st_p, c_p, rule)
    assert int(st_k.ctl[mk.CTL_STEP]) > 0 and not bool(st_k.found)
    assert int(st_k.ctl[mk.CTL_RESCAN_MAX]) >= 1


@pytest.mark.parametrize("rule", ["centroid", "lance_williams"])
@pytest.mark.parametrize("data", ["grid", "grid_d2", "normal"])
def test_engine_on_card_matches_twin_loop(cuda, rule, data):
    """The exact engine on the card: K1 in CUDA graphs against the plain
    twin's loop run step by step; the launches are the merges plus at most
    FOUND_READ_EVERY - 1 gated no-op steps of the last replay."""
    x = _features(data, 700, 3)
    kw = dict(min_size=3, max_size=6, update_rule=rule,
              reassign_dropped=False, mesh=None, device=cuda)
    mk.launches = 0
    got = ward._constrained_ward(x, None, merge_step=mk.merge_step, **kw)
    merges = len(got.merges)
    assert merges == 700 - got.n_clusters_target
    assert merges <= mk.launches <= merges + ward.FOUND_READ_EVERY - 1
    want = ward._constrained_ward(x, None, merge_step=mk.merge_step_plain,
                                  eager=True, **kw)
    np.testing.assert_array_equal(got.merges, want.merges)
    assert got.cluster_map == want.cluster_map
    eager = ward._constrained_ward(x, None, merge_step=mk.merge_step,
                                   eager=True, **kw)
    np.testing.assert_array_equal(eager.merges, want.merges)


def test_graphed_loop_stops_on_a_stall(cuda):
    """Tight triplets under (4, 5): the merges stop at 2 per triplet, far
    below the step limit; the graphed loop notices within one replay."""
    rng = np.random.default_rng(14)
    centers = rng.normal(size=(256, 4)).astype(np.float32) * 100
    x = np.repeat(centers, 3, axis=0) + rng.integers(
        -1, 2, (768, 4)).astype(np.float32)
    kw = dict(min_size=4, max_size=5, update_rule="lance_williams",
              reassign_dropped=False, mesh=None, device=cuda)
    mk.launches = 0
    got = ward._constrained_ward(x, None, merge_step=mk.merge_step, **kw)
    assert len(got.merges) == 512
    assert 512 < mk.launches <= 512 + ward.FOUND_READ_EVERY
    want = ward._constrained_ward(x, None, merge_step=mk.merge_step_plain,
                                  eager=True, **kw)
    np.testing.assert_array_equal(got.merges, want.merges)


@pytest.mark.parametrize("rule", ["lance_williams", "centroid"])
def test_bucketed_engine_on_card_matches_twin_run(cuda, monkeypatch, rule):
    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import bucket_kernels as bk

    x = np.random.default_rng(5).normal(size=(3000, 32)).astype(np.float32)
    kw = dict(update_rule=rule, bucket_size=256, device=cuda)
    before = (bk.launches, mk.batched_launches)
    got = sharded.constrained_ward_bucketed(x, **kw)
    assert (bk.launches, mk.batched_launches) != before
    monkeypatch.setattr(sharded, "merge_loop_whole",
                        bk.merge_loop_whole_plain)
    monkeypatch.setattr(sharded, "lockstep_step", mk.lockstep_step_plain)
    want = sharded.constrained_ward_bucketed(x, **kw)
    np.testing.assert_array_equal(got.merges, want.merges)
    assert got.cluster_map == want.cluster_map


_K4_DTYPES = [torch.float32, torch.bfloat16, torch.int8]


def _k4_grid_case(dev, dtype, n, k, d, kk):
    """K4 against its twin on integer-grid data with exact ties across
    centroid tiles: indices, distances and tie order bit for bit."""
    from imageclust_tpu_torch.ops import pref_kernels as pk

    gen = torch.Generator(device=dev).manual_seed(n + k + d)
    hi = 127 if dtype == torch.int8 else 8
    x, c = (torch.randint(-hi, hi + 1, (m, d), generator=gen, device=dev,
                          dtype=torch.int16).to(dtype) for m in (n, k))
    c[k // 2:k // 2 + k // 4] = c[:k // 4]  # exact ties across tiles
    cn = pk.row_norms(c)
    before = pk.launches
    got = pk.pref_topk_block(x, c, cn, kk)
    assert pk.launches == before + 1
    want = pk.pref_topk_block_plain(x, c, cn, kk)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("dtype", _K4_DTYPES)
@pytest.mark.parametrize("n,k,d,kk", [(600, 19, 48, 8), (1000, 5209, 512, 8),
                                      (77, 130, 1000, 8), (65, 300, 33, 8),
                                      (300, 5, 64, 5), (513, 389, 1037, 8),
                                      (257, 389, 1000, 8), (130, 389, 2000, 8),
                                      (1, 5, 64, 5), (257, 128, 512, 8),
                                      (129, 1, 7, 1)])
def test_pref_topk_block_bit_identical_to_twin(cuda, dtype, n, k, d, kk):
    """K4 on integer-grid data (every product and sum exact in f32) equals
    its twin bit for bit: indices, distances and tie order. d = 33, 1037
    and 7 take zero-padded centroids and byte-wise row copies (4-byte ones
    in f32); bf16 rows of d = 1000 and 1037 and int8 rows of d = 1037 and
    2000 stream beside the centroid slabs, narrower ones stay resident;
    k = 5 and 1 are below one tile, 389 and 5209 end in a ragged one; n = 1
    and 257 leave a block mostly empty."""
    _k4_grid_case(cuda, dtype, n, k, d, kk)


@pytest.mark.parametrize("dtype", _K4_DTYPES)
@pytest.mark.parametrize("kk", range(1, 9))
def test_pref_topk_block_every_kk(cuda, dtype, kk):
    """Every list length the kernel takes, on the resident (d = 200) path."""
    _k4_grid_case(cuda, dtype, 257, 389, 200, kk)


@pytest.mark.parametrize("feature_dtype", ["float32", "bfloat16", "int8"])
def test_bucketed_engine_on_k4_matches_twin_run(cuda, monkeypatch,
                                                feature_dtype):
    """The engine at k >= _PREF_FUSED_MIN_K (lowered) runs the summarize
    pass as one K4 launch, keeps sizes in bounds and loses no image. On
    the int8 grid (centroids rounded onto it) every K4 sum is exact, so
    the run equals the one with every kernel swapped for its twin; f32 and
    bf16 centroids are means off the grid, where picks may differ at near
    ties."""
    from imageclust_tpu_torch.cluster import sharded
    from imageclust_tpu_torch.ops import bucket_kernels as bk
    from imageclust_tpu_torch.ops import pref_kernels as pk

    monkeypatch.setattr(sharded, "_PREF_FUSED_MIN_K", 2)
    x = np.random.default_rng(6).integers(-8, 9, (3000, 16)).astype(
        np.float32)
    kw = dict(bucket_size=64, feature_dtype=feature_dtype, device=cuda)
    before = pk.launches
    got = sharded.constrained_ward_bucketed(x, **kw)
    assert pk.launches == before + 1
    placed = sum(len(m) for m in got.cluster_map.values())
    assert placed + len(got.dropped) == 3000
    assert all(3 <= len(m) <= 6 for m in got.cluster_map.values())
    if feature_dtype != "int8":
        return
    monkeypatch.setattr(sharded, "pref_topk_block", pk.pref_topk_block_plain)
    monkeypatch.setattr(sharded, "merge_loop_whole",
                        bk.merge_loop_whole_plain)
    want = sharded.constrained_ward_bucketed(x, **kw)
    np.testing.assert_array_equal(got.merges, want.merges)
    assert got.cluster_map == want.cluster_map


# -- K5 and the ViT towers ------------------------------------------------------

_K5_TOL = {torch.bfloat16: 0.02, torch.float32: 1e-5}  # test_attention.py


@pytest.mark.parametrize("shape", [(64, 50, 12, 64), (7, 128, 16, 64),
                                   (5, 17, 4, 32), (3, 1, 1, 64),
                                   (2, 33, 3, 72)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_short_seq_attention_matches_twin(cuda, shape, dtype):
    from imageclust_tpu_torch.ops import attention as at

    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    before = at.launches
    got = at.short_seq_attention(q, k, v)
    assert at.launches == before + 1
    want = at.short_seq_attention_plain(q, k, v)
    tol = _K5_TOL[dtype]
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_attention_dispatch_on_card(cuda):
    from imageclust_tpu_torch.ops import attention as at

    q = torch.randn((2, 129, 2, 64), device=cuda, dtype=torch.bfloat16)
    before = at.launches
    at.attention(q, q, q)  # T = 129: the plain path
    assert at.launches == before
    at.attention(q[:, :128].contiguous(), q[:, :128].contiguous(),
                 q[:, :128].contiguous())
    assert at.launches == before + 1
    with pytest.raises(ValueError):
        at.short_seq_attention(q, q, q)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tiny_vit_on_k5_matches_twin(cuda, monkeypatch, dtype):
    """A tiny tower of the ViT-B/32 shape class (T = 17, Dh = 64) on K5
    against the same tower with attention swapped for the twin."""
    from imageclust_tpu_torch.models import vit
    from imageclust_tpu_torch.ops import attention as at

    cfg = vit.ViTConfig(patch=8, width=256, depth=2, heads=4, proj_dim=32,
                        image_size=32)
    model = vit.VisionTransformer(cfg, dtype=dtype, norm_dtype=dtype)
    model = model.init_random(0).to(cuda).eval()
    x = torch.randn((16, 32, 32, 3), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    before = at.launches
    with torch.inference_mode():
        got = model(x)
        assert at.launches == before + cfg.depth
        monkeypatch.setattr(vit, "attention", at.short_seq_attention_plain)
        want = model(x)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert float(cos.min()) >= (0.999 if dtype == "bfloat16" else 0.99999)


# -- int8 products and the int8 towers (models/quantize*.py, ops/int8.py) ----

@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (5, 3, 7), (16, 64, 24),
                                   (17, 33, 9), (49, 2048, 512),
                                   (50, 768, 3072), (3000, 576, 64)])
def test_int8_mm_on_card_equals_plain(cuda, m, k, n):
    from imageclust_tpu_torch.ops.int8 import int8_mm

    gen = torch.Generator().manual_seed(m * k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    want = int8_mm(a, b.t())
    for bb in (b.t(), b.t().contiguous()):  # column- and row-major
        got = int8_mm(a.to(cuda), bb.to(cuda))
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k,stride,pad", [(1, 1, 0), (1, 2, 0), (3, 1, 1),
                                          (3, 2, 1), (7, 2, 3)])
@pytest.mark.parametrize("hw", [(7, 7), (9, 13), (56, 56)])
def test_int8_conv2d_on_card_equals_plain(cuda, k, stride, pad, hw):
    from imageclust_tpu_torch.ops.int8 import int8_conv2d

    gen = torch.Generator().manual_seed(k + stride + hw[0])
    x = torch.randint(-127, 128, (3, *hw, 24), generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (40, k, k, 24), generator=gen,
                      dtype=torch.int8)
    want = int8_conv2d(x, w, stride, pad)
    got = int8_conv2d(x.to(cuda), w.to(cuda), stride, pad)
    assert torch.equal(got.cpu(), want)


def test_int8_mm_refuses_mixed_devices(cuda):
    from imageclust_tpu_torch.ops.int8 import int8_mm

    a = torch.ones((32, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="operands on"):
        int8_mm(a.to(cuda), a.t())


def _cos_min(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.float().cpu(), b.float().cpu(), dim=1).min())


def test_int8_resnet50_on_card_matches_cpu(cuda):
    """The full-width int8 ResNet50 (seeded random init, calibrated on the
    CPU) on the card against the same tower on the CPU, both input paths."""
    import copy

    from imageclust_tpu_torch.models.quantize import quantize_resnet50
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1

    model = ResNet50V1(num_classes=1000).init_random(0)
    gen = torch.Generator().manual_seed(2)
    calib = torch.rand((4, 224, 224, 3), generator=gen)
    q_cpu = quantize_resnet50(model, calib).eval()
    q_gpu = copy.deepcopy(q_cpu).to(cuda)
    u8 = torch.randint(0, 256, (6, 224, 224, 3), generator=gen,
                       dtype=torch.uint8)
    with torch.inference_mode():
        for x in (u8, u8.flip(-1).float() / 255.0):
            want = q_cpu(x, return_features=True)
            got = q_gpu(x.to(cuda), return_features=True)
            for g, w in zip(got, want):
                assert torch.isfinite(g).all()
                assert _cos_min(g, w) >= 0.999


def test_int8_vit_b32_on_card_matches_cpu(cuda):
    """The full-width int8 ViT-B/32 on the card (K5 in every block) against
    the same tower on the CPU (the twin's attention)."""
    import copy

    from imageclust_tpu_torch.models import vit
    from imageclust_tpu_torch.models.quantize_vit import quantize_vit
    from imageclust_tpu_torch.ops import attention as at

    model = vit.VisionTransformer(vit.VIT_CONFIGS["vit_b32"]).init_random(0)
    gen = torch.Generator().manual_seed(3)
    q_cpu = quantize_vit(model, torch.randn((4, 224, 224, 3), generator=gen))
    q_gpu = copy.deepcopy(q_cpu).to(cuda)
    x = torch.randn((8, 224, 224, 3), generator=gen)
    with torch.inference_mode():
        want = q_cpu(x)
        before = at.launches
        got = q_gpu(x.to(cuda))
        assert at.launches == before + 12
    assert torch.isfinite(got).all()
    assert _cos_min(got, want) >= 0.999


def test_onnx_load_on_card(cuda, tmp_path):
    """``embed.onnx_path`` on the card: the loaded weights equal the
    exported ones bit for bit, and the tower embeds."""
    import numpy as np

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder
    from imageclust_tpu_torch.models.onnx_export import export_resnet50_onnx
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1

    src = ResNet50V1(num_classes=1000).init_random(7)
    path = tmp_path / "rn50.onnx"
    export_resnet50_onnx(src, str(path))
    emb = create_embedder(EmbedConfig(onnx_path=str(path), batch_size=8),
                          device="cuda")
    got = emb.model.state_dict()
    for k, v in src.state_dict().items():
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k].cpu(), v), k
    u8 = np.random.default_rng(0).integers(
        0, 256, (5, 224, 224, 3)).astype(np.uint8)
    out = emb.embed(u8)
    assert out.shape == (5, 1000) and np.isfinite(out).all()


# -- the text side -------------------------------------------------------------

@pytest.mark.parametrize("width,depth,heads", [(64, 2, 2), (512, 12, 8)])
def test_text_tower_on_card_matches_cpu(cuda, width, depth, heads):
    """The CLIP text tower (float32, plain torch attention, no K5) on the
    card against the same weights on the CPU; TF32 stays off."""
    import numpy as np

    from imageclust_tpu_torch.models import text
    from imageclust_tpu_torch.ops import attention as at

    cfg = text.TextConfig(vocab=49408, width=width, depth=depth,
                          heads=heads, proj_dim=512, eot_id=2)
    cpu = text.TextEncoder(cfg, bpe_path="", device="cpu")
    gpu = text.TextEncoder(cfg, state_dict=cpu.model.state_dict(),
                           bpe_path="", device="cuda")
    assert next(gpu.model.parameters()).device.type == "cuda"
    texts = [f"a photo of label {i} number {i * 7}" for i in range(300)]
    before = at.launches
    got = gpu.encode(texts)
    assert at.launches == before  # the text tower never reaches K5
    want = cpu.encode(texts)
    assert got.shape == (300, 512) and got.dtype == np.float32
    assert _cos_min(torch.from_numpy(got), torch.from_numpy(want)) >= 0.99999
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert gpu.encode([]).shape == (0, 512)


def _labeler(n_labels, dim, device, dup=()):
    import numpy as np

    from imageclust_tpu_torch.labels.zero_shot import ZeroShotLabeler

    class Emb:
        spec = type("spec", (), {"dim": dim})

    Emb.device = torch.device(device)
    rng = np.random.default_rng(5)
    bank = rng.normal(size=(n_labels, dim)).astype(np.float32)
    for a, b in dup:
        bank[b] = bank[a]
    return ZeroShotLabeler([f"l{i}" for i in range(n_labels)], bank, Emb())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_zero_shot_on_card_matches_cpu(cuda, dtype, monkeypatch):
    """labels_from_embeddings on a card matrix in its residency dtype
    (scored in chunks on the card) against the same rows on the CPU,
    including duplicated bank rows (ties to the lower index)."""
    from imageclust_tpu_torch.labels import zero_shot

    monkeypatch.setattr(zero_shot, "_SCORE_ROWS", 4096)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((10_000, 512), generator=gen)
    if dtype == torch.int8:
        x = (x * 30).round().clamp(-127, 127)
    x = x.to(dtype)
    bank_rows = [(3, 7), (3, 9), (12, 2)]
    zs = _labeler(16, 512, "cuda", dup=bank_rows)
    x[:4] = (torch.from_numpy(zs.bank[[3, 12, 7, 2]]) * 100).round().to(
        dtype)
    got = zs.labels_from_embeddings(x.to(cuda), 5, 0.0)
    want = zs.labels_from_embeddings(x, 5, 0.0)
    same = sum([l.name for l in a] == [l.name for l in b]
               for a, b in zip(got, want))
    assert same >= 0.999 * len(want)  # near ties may order differently
    for a, b in zip(got, want):
        if [l.name for l in a] == [l.name for l in b]:
            for la, lb in zip(a, b):
                assert abs(la.confidence - lb.confidence) <= 1e-3
    names = [[l.name for l in r] for r in got[:4]]
    assert names[0][:3] == ["l3", "l7", "l9"]
    assert names[1][:2] == ["l2", "l12"]


def test_create_zero_shot_labeler_on_card(cuda, tmp_path, monkeypatch):
    """create_labeler("zero_shot") with an embedder on the card and a text
    checkpoint: the bank comes from the text tower on the card and labels
    come from a bf16 card matrix."""
    import numpy as np

    from imageclust_tpu_torch.config import LabelConfig
    from imageclust_tpu_torch.labels import create_labeler
    from imageclust_tpu_torch.models import text

    monkeypatch.delenv("IMAGECLUST_LABEL_BANK", raising=False)
    cfg = text.TextConfig(vocab=1000, width=64, depth=2, heads=1,
                          proj_dim=32, eot_id=2)
    tower = text.TextTransformer(cfg).init_random(2)
    sd = {"text_model.embeddings.token_embedding.weight":
          tower.token_embed.weight,
          "text_model.embeddings.position_embedding.weight":
          tower.pos_embed[0],
          "text_model.final_layer_norm.weight": tower.ln_final.weight,
          "text_model.final_layer_norm.bias": tower.ln_final.bias,
          "text_projection.weight": tower.projection.weight}
    hf = {"ln1": "layer_norm1", "ln2": "layer_norm2",
          "q": "self_attn.q_proj", "k": "self_attn.k_proj",
          "v": "self_attn.v_proj", "proj": "self_attn.out_proj",
          "mlp_up": "mlp.fc1", "mlp_down": "mlp.fc2"}
    for i in range(cfg.depth):
        for ours, theirs in hf.items():
            mod = getattr(getattr(tower, f"block{i}"), ours)
            for leaf in ("weight", "bias"):
                sd[f"text_model.encoder.layers.{i}.{theirs}.{leaf}"] = (
                    getattr(mod, leaf))
    path = tmp_path / "text.pt"
    torch.save({k: v.detach().clone() for k, v in sd.items()}, path)

    class Emb:
        spec = type("spec", (), {"dim": 32})
        device = cuda

    zs = create_labeler(LabelConfig(backend="zero_shot",
                                    text_checkpoint_path=str(path),
                                    cache=False), embedder=Emb())
    assert zs.bank.shape == (16, 32)
    assert np.allclose(np.linalg.norm(zs.bank, axis=1), 1.0, atol=1e-5)
    x = torch.from_numpy(zs.bank[[0, 5]]).to(cuda, torch.bfloat16)
    rows = zs.labels_from_embeddings(x, 3, 75.0)
    assert [r[0].name for r in rows] == [zs.names[0], zs.names[5]]


# -- the NN-chain engine and the scoreboards -----------------------------------

def _member_sets(res):
    return {frozenset(m) for m in res.cluster_map.values()}


@pytest.mark.parametrize("impl", ["rnn", "seq"])
def test_chain_on_card_matches_cpu(cuda, monkeypatch, impl):
    """Tie-free Gaussian features: the card's chain (rounds, or the
    sequential chain in CUDA graph replays) gives the CPU's partition."""
    from imageclust_tpu_torch.cluster import constrained_ward_chain

    monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", impl)
    x = np.random.default_rng(3).standard_normal((1500, 32)).astype(
        np.float32)
    got = constrained_ward_chain(x, reassign_dropped=False, device=cuda)
    want = constrained_ward_chain(x, reassign_dropped=False, device="cpu")
    assert _member_sets(got) == _member_sets(want)
    assert set(got.dropped) == set(want.dropped)
    assert got.loop_stats["impl"] == impl


def test_chain_matches_greedy_on_card(cuda):
    from imageclust_tpu_torch.cluster import (
        constrained_ward,
        constrained_ward_chain,
    )

    x = np.random.default_rng(4).standard_normal((1024, 16)).astype(
        np.float32)
    got = constrained_ward_chain(x, reassign_dropped=False, device=cuda)
    want = constrained_ward(x, update_rule="centroid", device=cuda)
    assert _member_sets(got) == _member_sets(want)
    assert set(got.dropped) == set(want.dropped)


@pytest.mark.parametrize("impl", ["rnn", "seq"])
def test_chain_leaves_card_features_unchanged(cuda, monkeypatch, impl):
    """An f32 tensor on the card is the engine's own input after
    ``.to(device, float32)``: the loops must work in a copy."""
    from imageclust_tpu_torch.cluster import constrained_ward_chain

    monkeypatch.setenv("IMAGECLUST_CHAIN_IMPL", impl)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((700, 24), generator=gen, device=cuda)
    before = x.clone()
    res = constrained_ward_chain(x, device=cuda)
    assert torch.equal(x, before)
    assert sum(len(m) for m in res.cluster_map.values()) \
        + len(res.dropped) == 700


def test_residency_scoreboard_row_on_card(cuda):
    from imageclust_tpu_torch.cluster.quality import residency_scoreboard

    sb = residency_scoreboard(600, 32, sep=50.0, k=120, balanced=True,
                              device=cuda)
    for mode in ("bfloat16", "int8"):
        assert sb[mode]["ari"] >= 0.99, sb[mode]
    assert sb["f32"]["ari_vs_truth"] >= 0.99


def test_chain_gram_on_card_sums_in_float64(cuda):
    """The chain's Gram tile on the card: float64 sums rounded once to
    float32 (on the CPU an f32 product, as XLA's CPU rounds)."""
    from imageclust_tpu_torch.cluster import chain

    gen = torch.Generator().manual_seed(6)
    a = torch.randn((300, 512), generator=gen)
    b = torch.randn((200, 512), generator=gen)
    got = chain._gram(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.float32
    want = (a.double() @ b.double().T).float()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def _small_resnet(dtype="float32", classes=8, seed=0):
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1

    return ResNet50V1(num_classes=classes, dtype=dtype,
                      stage_layers=(1, 1, 1, 1)).init_random(seed)


def test_train_step_on_card_matches_cpu(cuda):
    """One float32 train step (TF32 off) from the same weights and batch:
    loss at rtol 1e-4, each gradient at a relative L2 of 1e-3, the running
    statistics at rtol 1e-4 of each buffer's largest magnitude, and the
    AdamW-updated weights close."""
    import copy

    from imageclust_tpu_torch.models.train import (
        init_opt_state,
        make_train_step,
    )

    gen = torch.Generator().manual_seed(12)
    images = torch.rand((8, 3, 64, 64), generator=gen)
    labels = torch.randint(0, 8, (8,), generator=gen)
    host = _small_resnet()
    card = copy.deepcopy(host).to(cuda)
    losses = []
    for model, dev in ((host, "cpu"), (card, cuda)):
        step = make_train_step(model, learning_rate=1e-3)
        losses.append(float(step(model, init_opt_state(model),
                                 images.to(dev), labels.to(dev))))
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    hp = dict(host.named_parameters())
    for name, p in card.named_parameters():
        g, want = p.grad.cpu().double(), hp[name].grad.double()
        assert (g - want).norm() <= 1e-3 * max(float(want.norm()), 1e-30), \
            name
    hb = dict(host.named_buffers())
    for name, buf in card.named_buffers():
        want = hb[name]
        torch.testing.assert_close(buf.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A tower trained on the card, saved in Orbax's layout, served back
    through ``embed.checkpoint_path``: the same weights and bit-identical
    embeddings."""
    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models import create_embedder, registry
    from imageclust_tpu_torch.models.convert import (
        resnet50_flax_from_state_dict,
    )
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1
    from imageclust_tpu_torch.models.train import (
        init_opt_state,
        make_train_step,
    )
    from imageclust_tpu_torch.utils.checkpoint import save_variables

    model = _small_resnet("bfloat16", seed=3).to(cuda)
    step = make_train_step(model)
    gen = torch.Generator().manual_seed(2)
    step(model, init_opt_state(model),
         torch.rand((4, 3, 64, 64), generator=gen).to(cuda),
         torch.randint(0, 8, (4,), generator=gen).to(cuda))
    ck = str(tmp_path / "ck")
    save_variables(ck, resnet50_flax_from_state_dict(model))

    class Small(ResNet50V1):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, stage_layers=(1, 1, 1, 1), **kwargs)

    orig = registry.ResNet50V1
    registry.ResNet50V1 = Small
    try:
        emb = create_embedder(EmbedConfig(checkpoint_path=ck, num_classes=8),
                              device=cuda)
        mem = create_embedder(EmbedConfig(onnx_path="", num_classes=8),
                              device=cuda)
    finally:
        registry.ResNet50V1 = orig
    mem.model.load_state_dict(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(emb.model.state_dict()[k], v), k
    u8 = np.random.default_rng(0).integers(0, 256, (16, 224, 224, 3),
                                           np.uint8)
    a, b = emb.embed(u8), mem.embed(u8)
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert ":torch-ckpt-" in emb.tag


def test_orbax_fixture_reads_on_card_machine(cuda):
    """The committed fixture (the JAX package's OCDBT layout with zstd
    compressed blocks) decodes here: the card's machine has a libzstd."""
    from pathlib import Path

    from imageclust_tpu_torch.utils import orbax_io

    data = Path(__file__).resolve().parent / "data"
    got = orbax_io.restore_variables(str(data / "orbax_small"))
    with np.load(data / "expected.npz") as z:
        np.testing.assert_array_equal(
            got["params"]["dense0"]["kernel"], z["params.dense0.kernel"])
        np.testing.assert_array_equal(
            got["params"]["conv0"]["kernel"].view(torch.uint16).numpy(),
            z["params.conv0.kernel.bf16bits"])
    assert orbax_io.libzstd_path()


# -- the mesh on the card ---------------------------------------------------------
#
# Ranks started by launch_processes(device="cuda"); each worker asserts on
# the global result against the single-card run in its own process
# (imageclust_tpu_torch/parallel/_worker.py).


def test_mesh_nccl_world_of_one(cuda):
    """One rank over NCCL: psum, the train step (against the single-card
    step: loss rtol 1e-5, gradients 1e-4 relative L2) and the mesh
    bucketed engine (equal to the single-card engine in float32 and int8),
    each through NCCL's collectives."""
    from imageclust_tpu_torch.parallel import launch_processes

    outs = launch_processes("imageclust_tpu_torch.parallel._worker:verify_all",
                            1, device="cuda", backend="nccl", timeout=300)
    for line in ("psum ok", "train step ok", "bucketed ok", "nccl"):
        assert line in outs[0], outs[0][-2000:]


def test_mesh_gloo_two_ranks_share_the_card(cuda):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device): the same checks, gloo's collectives on card tensors."""
    from imageclust_tpu_torch.parallel import launch_processes

    outs = launch_processes("imageclust_tpu_torch.parallel._worker:verify_all",
                            2, device="cuda", backend="gloo", timeout=300)
    for out in outs:
        for line in ("psum ok", "train step ok", "bucketed ok", "gloo",
                     "device=cuda:0"):
            assert line in out, out[-2000:]


def test_nccl_refuses_two_ranks_on_one_card(cuda):
    """create_mesh names the problem before NCCL would (two ranks, one
    card, NCCL): the launch fails with the worker's ValueError."""
    from imageclust_tpu_torch.parallel import launch_processes

    if torch.cuda.device_count() > 1:
        pytest.skip("needs exactly one card")
    with pytest.raises(RuntimeError, match="need backend='gloo'"):
        launch_processes("imageclust_tpu_torch.parallel._worker:verify_psum",
                         2, device="cuda", backend="nccl", timeout=120)


# -- the cloud backends and verify ----------------------------------------------

def _tiny_text_checkpoint(path):
    """A seeded HF-named CLIPTextModel state dict of a small text tower."""
    from imageclust_tpu_torch.models import text

    cfg = text.TextConfig(vocab=96, width=64, depth=2, heads=2, proj_dim=12,
                          context=10, eot_id=2)
    state = text.TextTransformer(cfg).init_random(4).state_dict()
    sd = {"text_model." + theirs: (state[ours][0] if ours == "pos_embed"
                                   else state[ours])
          for ours, theirs in text._hf_pairs(cfg)}
    sd["text_projection.weight"] = state["projection.weight"]
    torch.save({k: v.contiguous() for k, v in sd.items()}, path)
    return str(path)


def test_verify_clip_text_on_card(cuda, tmp_path, capsys):
    """``cli verify --clip-text --device cuda``: PASS, with the report the
    CPU gives."""
    import json

    from imageclust_tpu_torch import cli, verify

    path = _tiny_text_checkpoint(tmp_path / "text.pt")
    got = verify.verify_clip_text(path, device="cuda")
    assert got == verify.verify_clip_text(path, device="cpu")
    assert got["ok"] and got["checks"]["ingested"]
    assert cli.main(["verify", "--clip-text", path, "--device", "cuda"]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("VERDICT: PASS")
    assert json.loads(out[:out.rindex("VERDICT")])["clip_text"] == got


def test_verify_onnx_on_card(cuda, tmp_path, capsys):
    """``verify --onnx`` on a seeded export: on the card its forward and
    the partition check (K1) pass where cv2, the reference's runtime, is
    importable; without cv2 the CLI fails structurally naming it."""
    import importlib.util
    import json

    from imageclust_tpu_torch import cli, verify
    from imageclust_tpu_torch.models.onnx_export import export_resnet50_onnx
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1

    path = str(tmp_path / "rn50.onnx")
    export_resnet50_onnx(ResNet50V1().init_random(7), path)
    rc = cli.main(["verify", "--onnx", path, "--sample", "6", "--device",
                   "cuda"])
    out = capsys.readouterr().out
    report = json.loads(out[:out.rindex("VERDICT")])
    if importlib.util.find_spec("cv2") is None:
        assert rc == 2 and "cv2" in report["error"]
        return
    before = mk.launches
    got = verify.verify_onnx(path, sample=6, device="cuda")
    assert mk.launches > before  # the partition check ran K1
    assert rc == 0 and got["ok"] and got["checks"]["assignments_equal"]
    assert got["checks"]["cosine_min"] > verify.COSINE_GATE


def test_cloud_job_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``Pipeline.run`` with Rekognition labels and Bedrock and OpenAI
    names (a stub at the transport's seam) on the card and on the CPU: the
    same clusters, labels and names; K1 ran on the card."""
    import base64
    import hashlib
    import json

    from imageclust_tpu_torch.config import (
        AppConfig,
        LabelConfig,
        NamingConfig,
    )
    from imageclust_tpu_torch.models.registry import Embedder, EmbedderSpec
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1
    from imageclust_tpu_torch.pipeline import Pipeline
    from imageclust_tpu_torch.types import UploadedImage
    from imageclust_tpu_torch.utils import aws

    rng = np.random.default_rng(0)
    names, blobs = [], []
    for g, base in enumerate([(200, 30, 30), (30, 200, 30), (30, 30, 200)]):
        for i in range(6):
            img = np.clip(np.asarray(base) + rng.integers(
                0, 20, (224, 224, 3)), 0, 255).astype(np.uint8)
            names.append(f"g{g}_{i}.ppm")
            blobs.append(b"P6 224 224 255\n" + img[..., ::-1].tobytes())
    group_of = {hashlib.sha256(b).hexdigest(): n[:2]
                for n, b in zip(names, blobs)}

    def stub(method, url, body, headers, timeout):
        req = json.loads(body)
        if "rekognition" in url:
            img = base64.b64decode(req["Image"]["Bytes"])
            g = group_of[hashlib.sha256(img).hexdigest()]
            return 200, json.dumps({"Labels": [
                {"Name": f"Colour {g}", "Confidence": 97.0}]}).encode()
        prompt = (req["messages"][-1]["content"] if "messages" in req
                  else req["inputText"])
        t = json.dumps({"title": hashlib.sha256(prompt.encode()).hexdigest()
                        [:10], "catchy_phrase": "p"})
        if "openai" in url:
            return 200, json.dumps({"choices": [{"message": {
                "content": t}}]}).encode()
        return 200, json.dumps({"content": [{"text": t}]}).encode()

    monkeypatch.setattr(aws, "http_request", stub)
    monkeypatch.setattr(aws, "_CACHE", aws.AwsCredentials("AK", "SK"))
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test")
    cfg = AppConfig(
        labels=LabelConfig(backend="rekognition", retry_delay_s=0.0),
        naming=NamingConfig(services=("claude_haiku", "gpt-3.5-turbo"),
                            retry_delay_s=0.0))
    spec = EmbedderSpec(name="resnet50", input_size=224, dim=64,
                        scale=1 / 255.0, mean=(0.0, 0.0, 0.0),
                        std=(1.0, 1.0, 1.0), bgr_input=True)
    src = ResNet50V1(num_classes=64, dtype="float32", norm_dtype="float32",
                     stage_layers=(1, 1, 1, 1),
                     stem_mode="s2d_raw").init_random(3)
    results = {}
    for dev in ("cuda", "cpu"):
        model = ResNet50V1(num_classes=64, dtype="float32",
                           norm_dtype="float32", stage_layers=(1, 1, 1, 1),
                           stem_mode="s2d_raw")
        model.load_state_dict(src.state_dict())
        emb = Embedder(spec, model, batch_size=8, device=torch.device(dev),
                       tag=f"cloud-{dev}")
        before = mk.launches
        res = Pipeline(cfg, device=dev, embedder=emb).run(
            [UploadedImage(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / dev), min_size=3, max_size=6)
        results[dev] = (res.to_dict()["clusters"], res.dropped,
                        mk.launches - before, res.metrics.counters["merges"])
    (gpu, gpu_drop, k1, merges), (cpu, cpu_drop, k1_cpu, _) = (
        results["cuda"], results["cpu"])
    assert gpu == cpu and gpu_drop == cpu_drop
    assert merges <= k1 <= merges + ward.FOUND_READ_EVERY and k1_cpu == 0
    for c in gpu.values():
        assert c["labels"].startswith("Colour g")
        assert [o["serviceName"] for o in c["serviceOutputs"]] == [
            "OpenAI GPT-3.5 Turbo", "Claude Haiku v3.5"]


# -- K6 (ops/bn_act.py) -------------------------------------------------------

def _k6_operands(gen, shape, dt, nd, residual, dev):
    from imageclust_tpu_torch.models.resnet50 import _BatchNorm

    def act(dtype):
        return (torch.randn(shape, generator=gen) * 3).to(dtype).to(
            dev).contiguous(memory_format=torch.channels_last)

    def vectors():
        c = shape[1]
        bn = _BatchNorm(c)
        with torch.no_grad():
            bn.running_mean.copy_(torch.rand(c, generator=gen) - 0.5)
            bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
            bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
            bn.bias.copy_(torch.rand(c, generator=gen) - 0.5)
        with torch.no_grad():
            return tuple(v.to(dev) for v in bn.vectors())

    res = rvec = None
    if residual == "raw":
        res = act(nd)
    elif residual == "projected":
        res, rvec = act(dt), vectors()
    return act(dt), vectors(), res, rvec


@pytest.mark.parametrize("shape", [(3, 64, 5, 7), (2, 2048, 1, 1),
                                   (1, 24, 3, 3), (5, 256, 9, 2)])
@pytest.mark.parametrize("residual", ["none", "raw", "projected"])
@pytest.mark.parametrize("dt,nd", [(torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.float32, torch.float32),
                                   (torch.float32, torch.bfloat16)])
def test_bn_act_bit_identical_to_twin(cuda, shape, residual, dt, nd):
    from imageclust_tpu_torch.ops import bn_act as ba

    gen = torch.Generator().manual_seed(shape[1] + len(residual))
    x, vec, res, rvec = _k6_operands(gen, shape, dt, nd, residual, cuda)
    for relu in (False, True):
        before = ba.launches
        got = ba.bn_act(x, *vec, nd, res, rvec, relu=relu)
        assert ba.launches == before + 1
        want = ba.bn_act_plain(x, *vec, nd, res, rvec, relu=relu)
        torch.cuda.synchronize()
        assert got.dtype == nd and got.is_contiguous(
            memory_format=torch.channels_last)
        assert torch.equal(got.float().cpu(), want.float().cpu())


@pytest.mark.parametrize("dtype,norm_dtype", [("bfloat16", "bfloat16"),
                                              ("bfloat16", "float32"),
                                              ("float32", "float32")])
def test_resnet50_on_k6_bit_identical_to_twin(cuda, monkeypatch, dtype,
                                              norm_dtype):
    """The tower's logits with K6 against the same tower with the twin in
    its place (49 launches a batch at full depth)."""
    from imageclust_tpu_torch.models import resnet50 as rn
    from imageclust_tpu_torch.ops import bn_act as ba

    model = rn.ResNet50V1(num_classes=64, dtype=dtype, norm_dtype=norm_dtype,
                          stem_mode="s2d_raw").init_random(5).to(cuda)
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (3, 64, 64, 3), dtype=np.uint8)).to(cuda)
    with torch.inference_mode():
        before = ba.launches
        got = model(x)
        assert ba.launches == before + 49
        monkeypatch.setattr(rn, "batch_norm_act", ba.bn_act_plain)
        want = model(x)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("residual", ["none", "raw", "projected"])
def test_bn_act_empty_batch(cuda, residual):
    """N = 0 (an empty blob) returns an empty output and launches nothing."""
    from imageclust_tpu_torch.ops import bn_act as ba

    x = torch.zeros((0, 64, 7, 7), dtype=torch.bfloat16, device=cuda
                    ).contiguous(memory_format=torch.channels_last)
    v = torch.zeros(64, device=cuda)
    res = None if residual == "none" else x
    rvec = (v, v, v) if residual == "projected" else None
    before = ba.launches
    got = ba.bn_act(x, v, v, v, torch.bfloat16, res, rvec, relu=True)
    assert got.shape == x.shape and ba.launches == before


@pytest.mark.parametrize("tracked", ["x", "mul"])
def test_bn_act_raises_where_autograd_tracks(cuda, tracked):
    """The kernel has no backward: a tracked operand raises, nothing falls
    back to the twin."""
    from imageclust_tpu_torch.ops import bn_act as ba

    x = torch.zeros((2, 64, 3, 3), device=cuda).contiguous(
        memory_format=torch.channels_last)
    v = torch.ones(64, device=cuda)
    mul = v.clone()
    (x if tracked == "x" else mul).requires_grad_()
    before = ba.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ba.batch_norm_act(x, v, mul, v, torch.float32, relu=True)
    with torch.no_grad():
        ba.batch_norm_act(x, v, mul, v, torch.float32, relu=True)
    assert ba.launches == before + 1
