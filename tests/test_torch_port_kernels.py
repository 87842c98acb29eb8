"""The port's decode kernels on the CPU: their plain versions against
the JAX Pallas kernels in interpret mode. The CUDA kernels are held
against these plain versions on the card in tests/test_torch_port_cuda.py.

On the CPU a wrapper runs its plain version. XLA's and torch's CPU
sigmoids may differ by an ulp, so values compare at atol 1e-6;
indices and the suppression pattern compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structuredetector_tpu.ops.pallas.nms import fused_sigmoid_nms
from structuredetector_tpu.ops.pallas.topk import fused_sigmoid_nms_topk
from structuredetector_tpu_torch.ops.kernels import (
    launch_counts,
    reset_launch_counts,
    sigmoid_nms,
    sigmoid_nms_reference,
    sigmoid_nms_topk,
)
from structuredetector_tpu_torch.ops.tensor import select_topk


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _planes(x: np.ndarray) -> np.ndarray:
    b, h, w, c = x.shape
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)).reshape(b * c, h, w))


def test_sigmoid_nms_matches_pallas(rng):
    x = rng.normal(0, 3, size=(2, 16, 24, 3)).astype(np.float32)
    want = np.asarray(fused_sigmoid_nms(jnp.asarray(x), interpret=True))
    got = np.transpose(sigmoid_nms(_nchw(x)).numpy(), (0, 2, 3, 1))
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sigmoid_nms_peaks_survive():
    x = np.full((1, 16, 16, 1), -10.0, np.float32)
    x[0, 5, 5, 0] = 4.0
    want = np.asarray(fused_sigmoid_nms(jnp.asarray(x), interpret=True))
    got = np.transpose(sigmoid_nms(_nchw(x)).numpy(), (0, 2, 3, 1))
    assert got[0, 5, 5, 0] == np.float32(1 / (1 + np.exp(-4.0)))
    assert got[0, 5, 6, 0] == 0.0  # neighbours suppressed
    assert got[0, 12, 12, 0] > 0  # a flat region: every pixel is its window max
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("variant", ["rounds", "onehot"])
@pytest.mark.parametrize(
    "shape,k",
    [
        ((3, 32, 48, 2), 12),
        ((4, 16, 16, 2), 5),
        ((1, 32, 32, 1), 40),  # k > peak count: zeros taken in ascending index
        ((2, 24, 40, 3), 7),
        ((5, 16, 16, 2), 6),
        ((25, 16, 16, 2), 4),
        ((1, 40, 72, 2), 9),  # ragged 32 x 64 tiles
        ((1, 33, 65, 1), 9),
    ],
)
def test_sigmoid_nms_topk_matches_pallas(rng, shape, k, variant):
    """Each variant of the port (kernel B "rounds", kernel C "onehot";
    on the CPU both run the one plain version) against the same variant
    of the Pallas kernel."""
    x = rng.normal(0, 3, size=shape).astype(np.float32)
    x[0, 4:7, 4:7, 0] = 2.5  # a plateau exercises the tie order
    planes = _planes(x)
    want_v, want_i = fused_sigmoid_nms_topk(jnp.asarray(planes), k, interpret=True,
                                            variant=variant)
    got_v, got_i = sigmoid_nms_topk(torch.from_numpy(planes), k, variant=variant)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)


@pytest.mark.parametrize("variant", ["rounds", "onehot"])
def test_sigmoid_nms_topk_tie_break_ascending(variant):
    """All-equal plane: every pixel is its own plateau peak, and the
    selection walks ascending flat indices at the shared value."""
    planes = np.zeros((1, 16, 16), np.float32)
    want_v, want_i = fused_sigmoid_nms_topk(jnp.asarray(planes), 5, interpret=True,
                                            variant=variant)
    got_v, got_i = sigmoid_nms_topk(torch.from_numpy(planes), 5, variant=variant)
    np.testing.assert_array_equal(got_i.numpy()[0], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), 0.5, atol=1e-6)


def test_sigmoid_nms_topk_rejects_oversized_k():
    with pytest.raises(ValueError, match="exceeds plane size"):
        sigmoid_nms_topk(torch.zeros((1, 4, 4)), 17)
    with pytest.raises(ValueError, match="exceeds plane size"):
        fused_sigmoid_nms_topk(jnp.zeros((1, 4, 4)), 17, interpret=True)


@pytest.mark.parametrize("variant", ["rounds", "onehot"])
def test_sigmoid_nms_topk_of_no_planes(variant):
    vals, inds = sigmoid_nms_topk(torch.zeros((0, 8, 8)), 3, variant=variant)
    assert vals.shape == inds.shape == (0, 3)
    assert vals.dtype == torch.float32 and inds.dtype == torch.int32


def test_unknown_topk_variant_raises():
    """Both packages refuse a variant they do not have, rather than
    running another kernel."""
    with pytest.raises(ValueError, match="unknown variant"):
        sigmoid_nms_topk(torch.zeros((1, 8, 8)), 3, variant="bitonic")
    with pytest.raises(ValueError, match="unknown variant"):
        fused_sigmoid_nms_topk(jnp.zeros((1, 8, 8)), 3, interpret=True, variant="bitonic")


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError, match="float32"):
        sigmoid_nms(torch.zeros((1, 1, 8, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="B, C, H, W"):
        sigmoid_nms(torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError, match="N, H, W"):
        sigmoid_nms_topk(torch.zeros((1, 1, 8, 8)), 3)
    with pytest.raises(TypeError, match="float32"):
        sigmoid_nms_topk(torch.zeros((1, 8, 8), dtype=torch.bfloat16), 3)
    head = torch.zeros((2, 7, 8, 8))
    with pytest.raises(ValueError, match="contiguous"):
        sigmoid_nms(head[:, :2])  # a channel slice of a batched head
    with pytest.raises(ValueError, match="contiguous"):
        sigmoid_nms_topk(head[:, 2:3].reshape(2, 8, 8), 3)  # a strided view
    with pytest.raises(ValueError, match="256x256"):
        sigmoid_nms_topk(torch.zeros((1, 257, 256)), 3)
    with pytest.raises(ValueError, match="k must be"):
        sigmoid_nms_topk(torch.zeros((1, 8, 8)), 0)


def test_cpu_wrappers_count_no_launches(rng):
    """A CPU tensor runs the plain version, which is not a kernel launch."""
    before = launch_counts()
    x = torch.from_numpy(rng.normal(0, 3, (2, 3, 16, 16)).astype(np.float32))
    sigmoid_nms(x)
    sigmoid_nms_topk(x.reshape(6, 16, 16), 4)
    sigmoid_nms_topk(x.reshape(6, 16, 16), 4, variant="onehot")
    assert launch_counts() == before


def test_launch_counts_name_every_kernel_and_reset():
    sigmoid_nms_topk.launches_by_variant["onehot"] += 3  # as three launches would
    assert launch_counts()["sigmoid_nms_topk_rowmax"] >= 3
    reset_launch_counts()
    assert launch_counts() == {"sigmoid_nms": 0, "sigmoid_nms_topk": 0,
                               "sigmoid_nms_topk_rowmax": 0, "swin_window_attention": 0}


def test_sigmoid_nms_on_ragged_tiles_matches_pallas(rng):
    """Planes whose edges cut kernel A's 32-wide, 64-tall tiles."""
    for shape in ((1, 33, 65, 2), (1, 70, 40, 1)):
        x = rng.normal(0, 3, size=shape).astype(np.float32)
        want = np.asarray(fused_sigmoid_nms(jnp.asarray(x), interpret=True))
        got = np.transpose(sigmoid_nms(_nchw(x)).numpy(), (0, 2, 3, 1))
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, atol=1e-6)


# ---- kernel B's two-phase selection, mimicked in plain torch ----------------

def _keys(sup: torch.Tensor) -> torch.Tensor:
    """(N, H, W) suppressed values -> int64 keys (value bits << 32) |
    (0xFFFFFFFF - flat index), as kernel B packs them."""
    n, h, w = sup.shape
    bits = sup.contiguous().view(torch.int32).to(torch.int64)
    flat = torch.arange(h * w, dtype=torch.int64).reshape(h, w)
    return (bits << 32) | (0xFFFFFFFF - flat)


def _two_phase(sup: torch.Tensor, k: int, tile_h: int, tile_w: int):
    """Phase 1: each tile's best min(k, pixels) keys, sorted, 0 after
    (cells past the ragged edge are key 0); phase 2: every candidate's
    rank is the number of candidates above it, and rank r < k is output
    r. Returns (values, flat indices) as the kernel does."""
    n, h, w = sup.shape
    ty, tx = -(-h // tile_h), -(-w // tile_w)
    cap = min(k, min(h, tile_h) * min(w, tile_w))
    keys = torch.zeros((n, ty * tile_h, tx * tile_w), dtype=torch.int64)
    keys[:, :h, :w] = _keys(sup)
    tiles = keys.reshape(n, ty, tile_h, tx, tile_w).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(n, ty * tx, tile_h * tile_w)
    valid = (tiles != 0).sum(-1, keepdim=True)
    best = torch.sort(tiles, dim=-1, descending=True).values[..., :cap]
    slot = torch.arange(cap)
    cand = torch.where(slot < torch.clamp(valid, max=k), best, torch.zeros_like(best))
    flat = cand.reshape(n, -1)
    rank = (flat[:, None, :] > flat[:, :, None]).sum(-1)
    out = torch.zeros((n, k), dtype=torch.int64)
    for p in range(n):
        hit = (flat[p] != 0) & (rank[p] < k)
        out[p, rank[p][hit]] = flat[p][hit]
    assert (out != 0).all(), "every output slot written once"
    vals = (out >> 32).to(torch.int32).view(torch.float32)
    inds = (0xFFFFFFFF - (out & 0xFFFFFFFF)).to(torch.int32)
    return vals, inds


def _tile_cases():
    rng = np.random.default_rng(926354916)
    border = rng.normal(0, 3, (1, 70, 40)).astype(np.float32)
    border[:, 60:68, 28:36] = 20.0  # one plateau across tile borders (rows 64, column 32)
    yy, xx = np.mgrid[0:70, 0:40]
    cone = (5.0 - np.hypot(yy - 30, xx - 20) / 20.0).astype(np.float32)[None]
    saturated = np.full((2, 70, 40), -20.0, np.float32)  # clamps to 1e-6: every pixel a peak
    saturated[0, 10, 12] = saturated[1, 50, 30] = 2.0
    return {
        "random": (rng.normal(0, 3, (3, 70, 40)).astype(np.float32), 20),
        "saturated background, one peak": (saturated, 20),
        "all-equal": (np.zeros((1, 70, 40), np.float32), 30),
        "plateau across tile borders": (border, 40),
        "ragged 40x72": (rng.normal(0, 3, (2, 40, 72)).astype(np.float32), 9),
        "ragged 33x65": (rng.normal(0, 3, (2, 33, 65)).astype(np.float32), 9),
        "one peak, k > a tile's pixels": (cone, 2100),
        "k = H * W": (rng.normal(0, 3, (1, 33, 65)).astype(np.float32), 33 * 65),
    }


@pytest.mark.parametrize("tile", [(64, 32), (8, 4), (7, 5)],
                         ids=["kernel-tiles", "8x4-tiles", "7x5-tiles"])
@pytest.mark.parametrize("case", list(_tile_cases()))
def test_two_phase_selection_is_exact(case, tile):
    """The union of each tile's top min(k, pixels), merged by rank, is the
    plane's top k: held to select_topk on the same suppressed planes
    (exactly) and to the Pallas kernel (indices exactly; values to an ulp
    of XLA's sigmoid), at kernel B's tiles (64 tall, 32 wide), at small
    ones and at 7x5 tiles, ragged on every plane here: the merge is exact
    for any tiling."""
    planes, k = _tile_cases()[case]
    sup = sigmoid_nms_reference(torch.from_numpy(planes).unsqueeze(1)).squeeze(1)
    got_v, got_i = _two_phase(sup, k, *tile)
    want_v, want_i = select_topk(sup.reshape(sup.shape[0], -1), k)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    torch.testing.assert_close(got_i, want_i.to(torch.int32), rtol=0, atol=0)
    pallas_v, pallas_i = fused_sigmoid_nms_topk(jnp.asarray(planes), k, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pallas_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(pallas_v), atol=1e-6)


# ---- kernel C's cluster selection, mimicked in plain torch ------------------

_CLUSTER = 8  # blocks a plane
_LANES = 32


def _cluster_rounds(sup: torch.Tensor, k: int, run: int, tile_h: int = 64, tile_w: int = 32):
    """Kernel C's route over (N, H, W) suppressed values. The front: tile t
    goes to cluster rank t % 8 and lies in its slot t // 8, rows at a pitch
    of min(W, tile_w); table entry s is the max of flat indices
    [run * s, run * s + run), folded in tile by tile (atomicMax). Then k
    rounds: the winning run (max, then smallest run, from each lane's
    cached best of its slice of a power-of-two length), a read of that run
    from the blocks that own its pixels, the winning column, the mask (-1)
    stored there, the run's entry rewritten and the best of its slice
    renewed. Values are compared as int32 bits, as the kernel does. Returns
    (values, flat indices)."""
    n_planes, h, w = sup.shape
    n = h * w
    tiles_x = -(-w // tile_w)
    tiles = -(-h // tile_h) * tiles_x
    slot_w, slots = min(w, tile_w), -(-tiles // _CLUSTER)
    slot_px = min(h, tile_h) * slot_w
    runs = -(-n // run)
    per = 4  # entries a lane caches: a power of two, at least 4
    while _LANES * per < runs:
        per *= 2
    bits = sup.contiguous().view(torch.int32)
    flat = torch.arange(n).reshape(h, w)
    out_v = torch.empty((n_planes, k), dtype=torch.int32)
    out_i = torch.empty((n_planes, k), dtype=torch.int32)

    def owner(q):
        y, c = divmod(q, w)
        t = (y // tile_h) * tiles_x + c // tile_w
        return t % _CLUSTER, (t // _CLUSTER) * slot_px + (y % tile_h) * slot_w + c % tile_w

    for p in range(n_planes):
        smem = torch.full((_CLUSTER, slots * slot_px), -1, dtype=torch.int32)
        table = torch.full((runs,), -1, dtype=torch.int32)
        for t in range(tiles):
            oy, ox = (t // tiles_x) * tile_h, (t % tiles_x) * tile_w
            block = bits[p, oy:oy + tile_h, ox:ox + tile_w]
            vh, vw = block.shape
            base = (t // _CLUSTER) * slot_px
            smem[t % _CLUSTER, base:base + vh * slot_w].view(vh, slot_w)[:, :vw] = block
            runs_of = flat[oy:oy + vh, ox:ox + vw].reshape(-1) // run
            table.scatter_reduce_(0, runs_of, block.reshape(-1), "amax")
        padded = torch.full((runs * run,), -1, dtype=torch.int32)
        padded[:n] = bits[p].reshape(-1)
        assert torch.equal(table, padded.reshape(runs, run).amax(1)), "an entry is its run's max"
        smem, table = smem.tolist(), table.tolist()

        def best(lane):
            sl = table[lane * per:(lane + 1) * per]
            if not sl:
                return -2**31, 0
            top = max(sl)
            return top, lane * per + sl.index(top)

        cache = [best(lane) for lane in range(_LANES)]
        for r in range(k):
            top = max(v for v, _ in cache)
            lane = [v for v, _ in cache].index(top)  # the lowest lane: the smallest run
            s = cache[lane][1]
            qs = [q for q in range(s * run, s * run + run) if q < n]
            where = [owner(q) for q in qs]
            vals = [smem[rank][off] for rank, off in where]
            col = vals.index(top)
            rank, off = where[col]
            smem[rank][off] = -1
            table[s] = max([v for i, v in enumerate(vals) if i != col], default=-1)
            cache[lane] = best(lane)
            out_v[p, r], out_i[p, r] = top, qs[col]
    return out_v.view(torch.float32), out_i


def _cluster_cases():
    rng = np.random.default_rng(20240917)
    return {**_tile_cases(),
            "thin 1x300": (rng.normal(0, 3, (2, 1, 300)).astype(np.float32), 40),
            "thin 300x1": (rng.normal(0, 3, (2, 300, 1)).astype(np.float32), 40)}


@pytest.mark.parametrize("run", [32, 8, 5], ids=["kernel-runs", "8-runs", "5-runs"])
@pytest.mark.parametrize("case", list(_cluster_cases()))
def test_cluster_rounds_selection_is_exact(case, run):
    """Kernel C's route (tiles split over a cluster of 8, a table of run
    maxima, k rounds of winning run, rescan, mask and repair) is the
    plane's top k: held to select_topk on the same suppressed planes
    (exactly) and to the Pallas "onehot" kernel (indices exactly; values
    to an ulp of XLA's sigmoid), at the kernel's 32-pixel runs and at runs
    of 8 and 5 pixels, which cross row ends and tile borders."""
    planes, k = _cluster_cases()[case]
    sup = sigmoid_nms_reference(torch.from_numpy(planes).unsqueeze(1)).squeeze(1)
    got_v, got_i = _cluster_rounds(sup, k, run)
    want_v, want_i = select_topk(sup.reshape(sup.shape[0], -1), k)
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0)
    torch.testing.assert_close(got_i, want_i.to(torch.int32), rtol=0, atol=0)
    pallas_v, pallas_i = fused_sigmoid_nms_topk(jnp.asarray(planes), k, interpret=True,
                                                variant="onehot")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pallas_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(pallas_v), atol=1e-6)
