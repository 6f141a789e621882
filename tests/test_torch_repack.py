"""K7, the rechunk repack: heat_tpu_torch's plain version against
heat_tpu's Pallas kernel (interpret mode) and numpy on the CPU, and the CUDA
kernel against its plain version on the card.

Tolerance: none.  The kernel copies raw bytes, so every comparison is of
the bytes themselves, for every dtype."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu_torch.ops import repack as k7

# tests/test_kernels.py:140-146, then the other dtypes the engine moves
SHAPES = [
    ((1998, 10), np.float32),
    ((500, 13), np.float32),
    ((64, 64), np.int32),
    ((40, 17, 7), np.float32),
    ((4096, 1), np.float32),
    ((333, 11), np.bool_),
    ((333, 11), np.int8),
    ((250, 9), np.float16),
    ((250, 9), "bfloat16"),
    ((250, 9), np.float64),
]


@pytest.fixture(scope="module")
def ht():
    return pytest.importorskip("heat_tpu", reason="the parity tests need the JAX package")


def _flat(total, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.random(total) < 0.5
    if dtype == "bfloat16" or np.issubdtype(dtype, np.floating):
        return rng.standard_normal(total).astype(np.float32 if dtype == "bfloat16" else dtype)
    return rng.integers(-100, 100, total).astype(dtype)


def _torch(flat, dtype):
    t = torch.from_numpy(flat)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("shape,dtype", SHAPES, ids=lambda v: str(v))
def test_plain_repack_equals_heat_tpu_interpret_and_numpy(ht, monkeypatch, shape, dtype):
    import jax.numpy as jnp
    from heat_tpu.ops import repack as jrepack

    monkeypatch.setenv("HEAT_TPU_PALLAS", "interpret")
    total = int(np.prod(shape))
    flat = _flat(total, dtype, seed=total)
    src = _torch(flat, dtype)
    got = k7.reference_repack(src, shape)
    assert tuple(got.shape) == shape and got.is_contiguous() and got.dtype == src.dtype
    assert got.data_ptr() != src.data_ptr()
    jflat = jnp.asarray(flat).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(flat)
    want = np.asarray(jrepack.repack(jflat, shape, interpret=True))
    assert want.shape == shape
    assert torch.equal(_bytes(got), torch.from_numpy(np.array(want).view(np.uint8)).view(-1))
    assert torch.equal(_bytes(got), _bytes(src.reshape(shape)))
    # the wrapper on a CPU tensor is the plain version
    before = k7.calls, k7.launches
    assert torch.equal(_bytes(k7.repack(src, shape)), _bytes(got))
    assert (k7.calls, k7.launches) == (before[0] + 1, before[1])


def test_segments_against_torch_cat():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 255, 101).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 255, 37).astype(np.uint8))
    c = torch.from_numpy(rng.integers(0, 255, 64).astype(np.uint8))
    segs = [(a, 3, 27), (b, 1, 35), (c, 0, 0), (a, 50, 8)]
    got = k7.repack_segments(segs, (10, 7))
    want = torch.cat([a[3:30], b[1:36], a[50:58]]).reshape(10, 7)
    assert torch.equal(got, want)
    assert torch.equal(k7.reference_repack_segments(segs, (10, 7)), want)
    # one segment is exactly repack
    assert torch.equal(k7.repack_segments([(a, 0, 101)], (101,)), k7.repack(a, (101,)))


def test_zero_rows_and_bad_segments():
    src = torch.arange(12, dtype=torch.float32)
    assert tuple(k7.repack_segments([(src, 4, 0)], (0, 10)).shape) == (0, 10)
    with pytest.raises(ValueError):
        k7.repack_segments([(src, 0, 12)], (5, 2))  # 12 elements cannot fill 10
    with pytest.raises(ValueError):
        k7.repack_segments([(src, 8, 5)], (5,))  # past the source's end
    with pytest.raises(ValueError):
        k7.repack_segments([], (0,))
    with pytest.raises(TypeError):
        k7.repack_segments([(src, 0, 2), (src.double(), 0, 2)], (4,))
    with pytest.raises(ValueError):
        k7.repack_segments([(src.reshape(3, 4), 0, 12)], (12,))  # not 1-D


def test_non_contiguous_source_raises():
    src = torch.arange(24, dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        k7.repack_segments([(src[::2], 0, 12)], (12,))
    with pytest.raises(ValueError, match="contiguous"):
        k7.repack(src.reshape(4, 6).t(), (24,))


def test_sources_off_the_cpu_and_not_on_one_card_raise():
    # a tensor that is neither on the CPU nor on a card: no plain version,
    # no kernel
    cpu = torch.zeros(4)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        k7.repack_segments([(cpu, 0, 4), (meta, 0, 4)], (8,))
    with pytest.raises(ValueError, match="one CUDA device"):
        k7.repack_segments([(meta, 0, 4)], (4,))


# ------------------------------------------- K7's realignment, emulated in numpy
# The kernel (csrc/repack.cu) stores whole 16-byte destination words: the
# head up to the destination's first 16-byte boundary and the tail go byte
# by byte, and output word k is bytes [delta, delta + 16) of the aligned
# source words (w_k, w_k+1).  Each warp lane loads w_k, takes w_k+1 from the
# next lane (lane 31 from lane 0 of the next run of 32, or by one extra
# load), and builds its word from 32-bit lanes delta // 4 by a funnel shift
# of 8 (delta % 4) bits.  The emulation walks the same blocks, warps, runs
# and lanes, reads the source only as aligned 16-byte words of a simulated
# memory, and checks that no word it reads lies outside the aligned words
# that hold a segment's first and last byte.

_K7_SRC = (Path(__file__).resolve().parent.parent / "heat_tpu_torch" / "csrc" / "repack.cu").read_text()
KERNEL_GEOMETRY = {
    key: int(re.search(rf"constexpr int {name} = (\d+);", _K7_SRC).group(1))
    for key, name in (("threads", "kThreads"), ("unroll", "kUnroll"), ("tiles", "kTiles"))
}


def _funnel_r(lo, hi, s):
    """__funnelshift_r(lo, hi, s) for 0 <= s < 32 on uint32 arrays."""
    wide = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((wide >> np.uint64(s)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _emulate_repack(segments, dst_mod, threads, unroll, tiles):
    """K7 on ``segments`` of (bytes, source address mod 16), laid end to end
    into a destination that starts at ``dst_mod`` mod 16; returns the bytes."""
    chunk_words = threads * unroll * tiles
    total = sum(len(b) for b, _ in segments)
    out = np.full(total, 0xEE, np.uint8)
    table, blocks, pos = [], 0, 0
    for data, src_mod in segments:
        n = len(data)
        base = 1 << 12  # a 16-byte-aligned address; the segment starts at base + src_mod
        mem = np.zeros(src_mod + n + 32, np.uint8)
        mem[src_mod : src_mod + n] = data
        head = min((16 - (dst_mod + pos) % 16) % 16, n)
        words = (n - head) // 16
        table.append(dict(mem=mem, base=base, src=base + src_mod, dpos=pos, len=n, head=head, words=words, first=blocks))
        blocks += -(-words // chunk_words) if words else 1
        pos += n
    for block in range(blocks):
        g = [t for t in table if t["first"] <= block][-1]
        chunk = block - g["first"]
        lo, hi = g["src"] & ~15, (g["src"] + g["len"] + 15) & ~15

        def word(addr):  # one aligned 16-byte load as four little-endian uint32
            assert addr % 16 == 0 and lo <= addr and addr + 16 <= hi, "load outside the segment's aligned words"
            return g["mem"][addr - g["base"] : addr - g["base"] + 16].view("<u4").copy()

        if chunk == 0:
            for i in range(g["head"]):
                out[g["dpos"] + i] = g["mem"][g["src"] + i - g["base"]]
            tail_at = g["head"] + 16 * g["words"]
            for i in range(tail_at, g["len"]):
                out[g["dpos"] + i] = g["mem"][g["src"] + i - g["base"]]
        w0 = chunk * chunk_words
        w1 = min(w0 + chunk_words, g["words"])
        if w0 >= w1:
            continue
        s = g["src"] + g["head"]
        delta = s % 16
        sa = s - delta
        shift = delta != 0
        limit = w1 if shift else w1 - 1
        q, sh = delta // 4, 8 * (delta % 4)
        lanes = np.arange(32)
        for warp in range(threads // 32):
            run0 = w0 + warp * 32 * unroll
            while run0 < w1:
                ks = [run0 + 32 * u + lanes for u in range(unroll)]
                v = [np.stack([word(sa + 16 * int(k)) if k <= limit else np.zeros(4, np.uint32) for k in kk]) for kk in ks]
                k_extra = run0 + 32 * unroll
                extra = word(sa + 16 * k_extra) if shift and k_extra <= limit else np.zeros(4, np.uint32)
                for u in range(unroll):
                    outw = v[u]
                    if shift:
                        nxt = np.concatenate([v[u][1:], v[u][31:]])  # __shfl_down_sync: lane 31 keeps its own
                        nxt[31] = v[u + 1][0] if u + 1 < unroll else extra
                        both = np.concatenate([v[u], nxt], axis=1)  # (32, 8) uint32
                        outw = np.stack([_funnel_r(both[:, q + i], both[:, q + i + 1], sh) for i in range(4)], axis=1)
                    for lane in range(32):
                        k = int(ks[u][lane])
                        if k < w1:
                            at = g["dpos"] + g["head"] + 16 * k
                            assert (dst_mod + at) % 16 == 0
                            out[at : at + 16] = outw[lane].view(np.uint8)
                run0 += threads * unroll
    return out


def _emulated_against_plain(lengths, src_mods, dst_mod, seed, **geometry):
    rng = np.random.default_rng(seed)
    segments = [(rng.integers(0, 256, n).astype(np.uint8), m) for n, m in zip(lengths, src_mods)]
    got = _emulate_repack(segments, dst_mod, **geometry)
    srcs = [torch.from_numpy(np.concatenate([np.zeros(m, np.uint8), b])) for b, m in segments]
    want = k7.reference_repack_segments([(t, m, len(b)) for t, (b, m) in zip(srcs, segments)], (sum(lengths),))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("dst_mod", range(16))
@pytest.mark.parametrize("delta", range(16))
def test_emulated_realignment_every_offset_short(delta, dst_mod):
    # lengths 1..64 bytes: heads, tails and bodies of 0..3 words, at every
    # source shift delta (the source's offset from the destination mod 16)
    for n in range(1, 65):
        src_mod = (dst_mod + delta) % 16
        _emulated_against_plain([n], [src_mod], dst_mod, seed=n, **KERNEL_GEOMETRY)


@pytest.mark.parametrize("dst_mod", [0, 1, 4, 9, 15])
@pytest.mark.parametrize("delta", range(16))
def test_emulated_realignment_long_segments(delta, dst_mod):
    # a few thousand bytes: several runs of 32 words a warp, so lane 31 takes
    # its neighbour from the next run and from the extra load; the small
    # geometry cuts them into several chunks (blocks) as well
    src_mod = (dst_mod + delta) % 16
    for n in (2_000, 4_099, 16_387):
        _emulated_against_plain([n], [src_mod], dst_mod, seed=n, threads=64, unroll=2, tiles=1)
    _emulated_against_plain([3_001], [src_mod], dst_mod, seed=7, threads=32, unroll=4, tiles=2)


@pytest.mark.parametrize("geometry", [KERNEL_GEOMETRY, dict(threads=32, unroll=2, tiles=1)], ids=["kernel", "small"])
def test_emulated_realignment_eight_mixed_segments(geometry):
    # up to MAX_SEGMENTS segments in one launch, of mixed lengths and
    # alignments, one of them shorter than its head
    lengths = [1, 3_333, 17, 64, 2, 1_000, 15, 555]
    src_mods = [3, 0, 15, 4, 9, 1, 7, 12]
    assert len(lengths) == k7.MAX_SEGMENTS
    for dst_mod in (0, 5, 12):
        _emulated_against_plain(lengths, src_mods, dst_mod, seed=dst_mod, **geometry)


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CARD_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.bool, torch.float64, torch.int64,
               torch.complex64]


def _card_data(total, dtype, gen, dev):
    if dtype == torch.bool:
        return torch.rand(total, generator=gen, device=dev) < 0.5
    if dtype.is_floating_point or dtype.is_complex:
        return torch.randn(total, generator=gen, device=dev, dtype=dtype)
    return torch.randint(-100, 100, (total,), generator=gen, device=dev, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", CARD_DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1998, 10), (499_999, 3), (7, 1), (123_457, 33)], ids=str)
def test_kernel_bitwise_on_card(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(11)
    flat = _card_data(int(np.prod(shape)), dtype, gen, cuda)
    before = k7.launches
    got = k7.repack(flat, shape)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    assert got.is_cuda and got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(_bytes(got), _bytes(k7.reference_repack(flat, shape)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32, torch.float64], ids=str)
def test_kernel_segments_at_odd_offsets_on_card(cuda, dtype):
    # every pair of source and destination alignments: 1-byte offsets
    # differ modulo 16, f32 offsets modulo 4, so the kernel takes every
    # width from 1 to 16 bytes with heads and tails
    gen = torch.Generator(device=cuda).manual_seed(12)
    a = _card_data(100_003, dtype, gen, cuda)
    b = _card_data(77_777, dtype, gen, cuda)
    c = _card_data(31, dtype, gen, cuda)
    for starts in [(1, 3, 5), (0, 0, 0), (7, 2, 30), (15, 16, 1)]:
        segs = [(a, starts[0], 50_001), (c, starts[2], 1), (b, starts[1], 60_000), (a, 60_001, 29)]
        total = sum(s[2] for s in segs)
        before = k7.launches
        got = k7.repack_segments(segs, (total,))
        torch.cuda.synchronize()
        assert k7.launches == before + 1
        assert torch.equal(_bytes(got), _bytes(k7.reference_repack_segments(segs, (total,))))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32], ids=str)
def test_kernel_every_alignment_pair_on_card(cuda, dtype):
    # every (source mod 16, destination mod 16) pair the dtype allows: a
    # first segment of dst_mod bytes puts the second one's destination there
    gen = torch.Generator(device=cuda).manual_seed(13)
    src = _card_data(300_000, dtype, gen, cuda)
    item = src.element_size()
    for so in range(16 // item):
        for do in range(16 // item):
            for length in (1, 3, 17, 33, 1_000, 123_457):
                segs = ([(src, 200, do)] if do else []) + [(src, so, length)]
                total = sum(n for _, _, n in segs)
                before = k7.launches
                got = k7.repack_segments(segs, (total,))
                again = k7.repack_segments(segs, (total,))
                torch.cuda.synchronize()
                assert k7.launches == before + 2
                want = k7.reference_repack_segments(segs, (total,))
                assert torch.equal(_bytes(got), _bytes(want)), (so, do, length)
                assert torch.equal(_bytes(got), _bytes(again))


@pytest.mark.gpu
@pytest.mark.parametrize("count", range(2, k7.MAX_SEGMENTS + 1))
def test_kernel_short_and_mixed_segments_on_card(cuda, count):
    # 2..8 segments of 1..33 bytes and longer ones, at mixed alignments, in
    # one launch
    gen = torch.Generator(device=cuda).manual_seed(14 + count)
    a = _card_data(50_000, torch.int8, gen, cuda)
    rng = np.random.default_rng(count)
    for _ in range(20):
        lengths = rng.integers(1, 34, count)
        lengths[rng.integers(0, count)] = rng.integers(34, 20_000)
        segs = [(a, int(rng.integers(0, 16)), int(n)) for n in lengths]
        total = sum(n for _, _, n in segs)
        before = k7.launches
        got = k7.repack_segments(segs, (total,))
        torch.cuda.synchronize()
        assert k7.launches == before + 1
        assert torch.equal(_bytes(got), _bytes(k7.reference_repack_segments(segs, (total,))))


@pytest.mark.gpu
def test_kernel_segment_past_two_gib_on_card(cuda):
    # one f32 segment of 2^31 + 36 bytes, one element off 16-byte alignment
    total = (2**31 + 36) // 4
    free, _ = torch.cuda.mem_get_info()
    if free < 4 * 4 * total:
        pytest.skip("needs four copies of 2 GiB on the card")
    gen = torch.Generator(device=cuda).manual_seed(15)
    src = torch.randn(total + 1, generator=gen, device=cuda)
    got = k7.repack_segments([(src, 1, total)], (total,))
    torch.cuda.synchronize()
    assert torch.equal(_bytes(got), _bytes(src[1:]))
    del got
    again = k7.repack_segments([(src, 0, total)], (total,))
    torch.cuda.synchronize()
    assert torch.equal(_bytes(again), _bytes(src[:total]))


@pytest.mark.gpu
def test_kernel_zero_rows_and_reruns_on_card(cuda):
    src = torch.arange(30, dtype=torch.float32, device=cuda)
    before = k7.launches
    empty = k7.repack_segments([(src, 5, 0)], (0, 3))
    assert tuple(empty.shape) == (0, 3) and k7.launches == before
    got = k7.repack(src, (10, 3))
    again = k7.repack(src, (10, 3))
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, src.reshape(10, 3))


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda):
    src = torch.arange(64, dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k7.repack_segments([(src[::2], 0, 32)], (32,))
    with pytest.raises(ValueError, match="one CUDA device"):
        k7.repack_segments([(src, 0, 32), (src.cpu(), 0, 32)], (64,))
    with pytest.raises(ValueError, match="at most"):
        k7.repack_segments([(src, i, 1) for i in range(k7.MAX_SEGMENTS + 1)], (k7.MAX_SEGMENTS + 1,))


@pytest.mark.gpu
def test_transport_reshape_on_card_matches_cpu(cuda):
    import heat_tpu_torch as htt

    x = np.random.default_rng(5).standard_normal((999, 20)).astype(np.float32)
    for n in (1, 4, 8):
        mesh = htt.MeshComm(n)
        before = k7.launches
        got = htt.reshape(htt.array(torch.from_numpy(x).to(cuda), split=0, comm=mesh), (1998, 10))
        want = htt.reshape(htt.array(x, split=0, comm=mesh, device="cpu"), (1998, 10))
        torch.cuda.synchronize()
        assert k7.launches - before == (n if n > 1 else 0)
        for g, w in zip(got.shards, want.shards):
            assert torch.equal(_bytes(g.cpu()), _bytes(w))
