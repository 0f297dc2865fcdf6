"""The port's KTX2 container decoder and ETC1S / BasisLZ transcoder against
the JAX package's, on bytes built here.

KTX2 files (RGBA8, RGB8, R8, RG8; uncompressed, zlib, zstd) are written by
`ktx2_bytes`. A zstd payload decodes where the `zstandard` module is
installed and is None on both sides where it is not. For BasisLZ a bit
writer (`BitWriter`, the inverse of `basisu.BitReader`: LSB-first fields,
canonical Huffman codes MSB-first) builds Huffman tables (literal lengths
and the four run-length codes), endpoint and selector codebooks (raw,
XOR-delta and legacy-palette forms), the slice tables and slices that take
every path of `decode_slice` (the four endpoint predictions, the repeat
symbol with its VLC count, literal selectors, history references and runs
with the VLC escape), and whole ETC1S KTX2 files with two mip levels and
an alpha slice for `transcode_ktx2`. Every decode is compared bit for bit.
"""
import struct
import zlib

import numpy as np
import pytest

from idkengine_tpu.scene import basisu as j_basisu
from idkengine_tpu.scene import ktx2 as j_ktx2
from idkengine_tpu_torch.scene import basisu, ktx2
from worker_threads import share_cores

share_cores()

IDENTIFIER = b"\xabKTX 20\xbb\r\n\x1a\n"
FORMATS = {"rgba8": (37, 4), "srgba8": (43, 4), "rgb8": (23, 3), "srgb8": (29, 3),
           "r8": (9, 1), "rg8": (16, 2)}
ORDER = (17, 18, 19, 20, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15, 16)


def ktx2_bytes(vk_format, w, h, levels_payload, scheme=0, dfd=b"", sgd=b"", uncomp=None):
    """A KTX2 file: header, level index, DFD, supercompression global data,
    then each level's payload."""
    n = len(levels_payload)
    head = 80 + 24 * n
    dfd_off = head
    sgd_off = dfd_off + len(dfd)
    off = sgd_off + len(sgd)
    index, body = b"", b""
    for i, p in enumerate(levels_payload):
        ulen = len(p) if uncomp is None else uncomp[i]
        index += struct.pack("<QQQ", off + len(body), len(p), ulen)
        body += p
    hdr = IDENTIFIER + struct.pack("<9I", vk_format, 1, w, h, 0, 0, 1, n, scheme)
    hdr += struct.pack("<IIIIQQ", dfd_off if dfd else 0, len(dfd), 0, 0,
                       sgd_off if sgd else 0, len(sgd))
    return hdr + index + dfd + sgd + body


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("scheme", ["none", "zlib", "zstd"])
def test_decode_ktx2_matches_jax(fmt, scheme):
    vk, ch = FORMATS[fmt]
    rs = np.random.RandomState(len(fmt))
    w, h = 13, 7
    raw = rs.randint(0, 256, (h, w, ch)).astype(np.uint8).tobytes()
    code = {"none": 0, "zlib": 3, "zstd": 2}[scheme]
    payload = raw
    if scheme == "zlib":
        payload = zlib.compress(raw)
    elif scheme == "zstd":
        try:
            import zstandard
            payload = zstandard.ZstdCompressor().compress(raw)
        except ImportError:
            payload = b"\x28\xb5\x2f\xfd" + raw  # not decodable without the module
    data = ktx2_bytes(vk, w, h, [payload], scheme=code, uncomp=[len(raw)])
    assert ktx2.parse_header(data) == j_ktx2.parse_header(data)
    got, want = ktx2.decode_ktx2(data), j_ktx2.decode_ktx2(data)
    _same(got, want)
    try:
        import zstandard  # noqa: F401
        has_zstd = True
    except ImportError:
        has_zstd = False
    if scheme != "zstd" or has_zstd:
        assert got.shape == (h, w, 4)
        np.testing.assert_array_equal(got[..., :ch],
                                      np.frombuffer(raw, np.uint8).reshape(h, w, ch))
    else:
        assert got is None


def test_undecodable_ktx2_is_none_on_both_sides():
    raw = np.zeros((4, 4, 4), np.uint8).tobytes()
    for data in (b"not a ktx2 file at all" * 4,
                 ktx2_bytes(100, 4, 4, [raw]),  # a block format
                 ktx2_bytes(37, 4, 4, [raw], scheme=7)):
        assert ktx2.decode_ktx2(data) is None and j_ktx2.decode_ktx2(data) is None


# ---------------------------------------------------------------------------
# A BasisLZ writer
# ---------------------------------------------------------------------------

class BitWriter:
    """The inverse of basisu.BitReader: fields LSB-first in a byte stream."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        for i in range(n):
            self.bits.append((value >> i) & 1)

    def vlc(self, value: int, chunk_bits: int):
        while True:
            part = value & ((1 << chunk_bits) - 1)
            value >>= chunk_bits
            self.put(part | ((1 << chunk_bits) if value else 0), chunk_bits + 1)
            if not value:
                return

    def huff(self, code, sym: int):
        c, n = code[sym]
        for i in range(n):  # canonical codes go MSB-first
            self.bits.append((c >> (n - 1 - i)) & 1)

    def data(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8][::-1])), 2)
                     for i in range(0, len(bits), 8))


def canonical(sizes):
    """Deflate's canonical code of each symbol: {symbol: (code, length)}."""
    max_len = max(sizes)
    bl = [0] * (max_len + 1)
    for s in sizes:
        if s:
            bl[s] += 1
    code, next_code = 0, [0] * (max_len + 2)
    for n in range(1, max_len + 1):
        code = (code + bl[n - 1]) << 1
        next_code[n] = code
    out = {}
    for sym, n in enumerate(sizes):
        if n:
            out[sym] = (next_code[n], n)
            next_code[n] += 1
    return out


def code_lengths(used, total, rs, max_len=16):
    """Lengths for the symbols in `used` (the others 0) that satisfy Kraft's
    inequality, shortened at random from a balanced code."""
    used = sorted(set(used))
    base = max(1, int(np.ceil(np.log2(max(len(used), 2)))))
    sizes = [0] * total
    for s in used:
        sizes[s] = base
    for s in rs.permutation(used):
        while sizes[s] > 1 and sum(2.0 ** -x for x in sizes if x) + 2.0 ** -sizes[s] <= 1.0:
            sizes[s] -= 1
    assert max(sizes) <= max_len
    return sizes


def write_table(bw, sizes, rs, rle=True):
    """A Huffman table as read_huffman_table reads it; returns its code."""
    syms = []  # (code-length symbol, extra bits value, extra bits count)
    i = 0
    while i < len(sizes):
        run = 1
        while i + run < len(sizes) and sizes[i + run] == sizes[i]:
            run += 1
        v = sizes[i]
        if rle and v == 0 and run >= 11:
            k = min(run, 138)
            syms.append((18, k - 11, 7))
        elif rle and v == 0 and run >= 3:
            k = min(run, 10)
            syms.append((17, k - 3, 3))
        elif rle and i > 0 and sizes[i - 1] == v and run >= 7:
            k = min(run, 134)
            syms.append((20, k - 7, 7))
        elif rle and i > 0 and sizes[i - 1] == v and run >= 3:
            k = min(run, 6)
            syms.append((19, k - 3, 2))
        else:
            k = 1
            syms.append((v, 0, 0))
        i += k
    cl_sizes = code_lengths({s for s, _, _ in syms}, 21, rs, max_len=7)
    num_cl = max(j for j, o in enumerate(ORDER) if cl_sizes[o]) + 1
    bw.put(len(sizes), 14)
    bw.put(num_cl, 5)
    for j in range(num_cl):
        bw.put(cl_sizes[ORDER[j]], 3)
    cl_code = canonical(cl_sizes)
    for s, extra, n in syms:
        bw.huff(cl_code, s)
        bw.put(extra, n)
    return canonical(sizes)


def _table(rs, total, used, rle=True):
    bw = BitWriter()
    code = write_table(bw, code_lengths(used, total, rs), rs, rle)
    return bw, code


@pytest.mark.parametrize("seed", range(4))
def test_read_huffman_table_matches_jax(seed):
    rs = np.random.RandomState(seed)
    total = int(rs.choice([8, 64, 257, 1000]))
    used = rs.choice(total, size=max(2, total // (1 + seed)), replace=False)
    bw, code = _table(rs, total, used, rle=seed % 2 == 0)
    syms = rs.choice(sorted(used), 50)
    for s in syms:
        bw.huff(code, int(s))
    data = bw.data()
    out = []
    for mod in (basisu, j_basisu):
        br = mod.BitReader(data)
        t = mod.read_huffman_table(br)
        out.append((t.lut_sym.copy(), t.lut_len.copy(), [t.decode(br) for _ in syms], br.pos))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert out[0][2] == [int(s) for s in syms]


def write_endpoints(rs, n, grayscale=False):
    """An endpoint codebook of n random endpoints: (bytes, (n,4) values)."""
    vals = np.zeros((n, 4), np.int64)
    vals[:, :3] = rs.randint(0, 32, (n, 3))
    vals[:, 3] = rs.randint(0, 8, n)
    if grayscale:
        vals[:, 1] = vals[:, 2] = vals[:, 0]
    # the deltas each model must code, by a first pass over the values
    prev, prev_i = [16, 16, 16], 0
    used = {0: set(), 1: set(), 2: set(), 3: set()}
    plan = []
    for v in vals:
        di = (int(v[3]) - prev_i) & 7
        prev_i = int(v[3])
        used[3].add(di)
        row = [(3, di)]
        for c in range(1 if grayscale else 3):
            p = prev[c]
            m = 0 if p <= 9 else (1 if p <= 21 else 2)
            dc = (int(v[c]) - p) & 31
            used[m].add(dc)
            row.append((m, dc))
            prev[c] = int(v[c])
        if grayscale:
            prev[1] = prev[2] = prev[0]
        plan.append(row)
    bw = BitWriter()
    codes = [write_table(bw, code_lengths(used[m] | {0}, 32 if m < 3 else 8, rs), rs)
             for m in range(4)]
    bw.put(int(grayscale), 1)
    for row in plan:
        for m, sym in row:
            bw.huff(codes[m], sym)
    return bw.data(), vals


def write_selectors(rs, n, form="delta"):
    """A selector codebook: (bytes, (n,4) row bytes or None for a palette)."""
    rows = rs.randint(0, 256, (n, 4))
    bw = BitWriter()
    if form == "raw":
        bw.put(1, 1)
        for r in rows:
            for b in r:
                bw.put(int(b), 8)
        return bw.data(), rows
    bw.put(0, 1)
    if form == "palette":
        bw.put(1, 1)
        bw.put(0, 1)
        return bw.data(), None
    bw.put(0, 2)
    deltas = rows[1:] ^ rows[:-1]
    code = write_table(bw, code_lengths(set(deltas.reshape(-1).tolist()) | {0}, 256, rs), rs)
    for b in rows[0]:
        bw.put(int(b), 8)
    for d in deltas:
        for b in d:
            bw.huff(code, int(b))
    return bw.data(), rows


@pytest.mark.parametrize("grayscale", [False, True])
def test_decode_endpoints_matches_jax(grayscale):
    rs = np.random.RandomState(7 + grayscale)
    data, vals = write_endpoints(rs, 300, grayscale)
    got, want = basisu.decode_endpoints(data, 300), j_basisu.decode_endpoints(data, 300)
    _same(got, want)
    np.testing.assert_array_equal(got, vals)
    with pytest.raises(ValueError):  # one byte more is a mis-decoded stream on both sides
        basisu.decode_endpoints(data + b"\0", 300)
    with pytest.raises(ValueError):
        j_basisu.decode_endpoints(data + b"\0", 300)


@pytest.mark.parametrize("form", ["delta", "raw", "palette"])
def test_decode_selectors_matches_jax(form):
    rs = np.random.RandomState(11)
    data, rows = write_selectors(rs, 200, form)
    got, want = basisu.decode_selectors(data, 200), j_basisu.decode_selectors(data, 200)
    _same(got, want)
    if rows is not None:
        np.testing.assert_array_equal(got, rows)
    else:
        assert (got == 0xFF).all()


def test_mtf_matches_jax():
    rs = np.random.RandomState(3)
    a, b = basisu._MTF(16), j_basisu._MTF(16)
    for _ in range(400):
        if rs.rand() < 0.5:
            v = int(rs.randint(1000))
            a.add(v)
            b.add(v)
        else:
            i = int(rs.randint(16))
            a.use(i)
            b.use(i)
        assert a.values == b.values


def write_tables(rs, n_endpoints, n_selectors, hist_size):
    """The slice tables: (bytes, their codes)."""
    bw = BitWriter()
    codes = {
        "ep_pred": write_table(bw, code_lengths(range(257), 257, rs), rs),
        "delta_ep": write_table(bw, code_lengths(range(n_endpoints), n_endpoints, rs), rs),
        "sel": write_table(bw, code_lengths(range(n_selectors + hist_size + 1),
                                            n_selectors + hist_size + 1, rs), rs),
        "rle": write_table(bw, code_lengths(range(64), 64, rs), rs),
    }
    bw.put(hist_size, 13)
    return bw.data(), codes


def write_slice(rs, nbx, nby, n_endpoints, n_selectors, hist_size, codes):
    """A random slice that takes every path of decode_slice: the writer
    follows the decoder's control flow and draws each choice."""
    bw = BitWriter()
    pred_repeat, last_sym, cur = 0, 0, 0
    stash = [0] * ((nbx + 1) // 2)
    rle_count = 0
    marker = n_selectors + hist_size
    for by in range(nby):
        for bx in range(nbx):
            if bx & 1 == 0:
                if by & 1 == 0:
                    if pred_repeat > 0:
                        pred_repeat -= 1
                        cur = last_sym
                    elif rs.rand() < 0.15:
                        bw.huff(codes["ep_pred"], 256)
                        k = int(rs.randint(0, 40))
                        bw.vlc(k, 4)
                        pred_repeat = k + 2
                        cur = last_sym
                    else:
                        cur = int(rs.randint(256))
                        bw.huff(codes["ep_pred"], cur)
                        last_sym = cur
                    stash[bx >> 1] = cur >> 4
                else:
                    cur = stash[bx >> 1]
            else:
                cur >>= 2
            if cur & 3 == 3:
                bw.huff(codes["delta_ep"], int(rs.randint(n_endpoints)))
            if rle_count > 0:
                rle_count -= 1
                continue
            u = rs.rand()
            if u < 0.5 or not hist_size:
                bw.huff(codes["sel"], int(rs.randint(n_selectors)))
            elif u < 0.85:
                bw.huff(codes["sel"], n_selectors + int(rs.randint(hist_size)))
            else:
                bw.huff(codes["sel"], marker)
                r = int(rs.randint(64))
                bw.huff(codes["rle"], r)
                if r == 63:
                    v = int(rs.randint(0, 300))
                    bw.vlc(v, 7)
                    rle_count = 3 + v - 1
                else:
                    rle_count = 3 + r - 1
    return bw.data()


@pytest.mark.parametrize("hist_size", [0, 16, 64])
def test_decode_tables_and_slice_match_jax(hist_size):
    rs = np.random.RandomState(hist_size)
    n_ep, n_sel = 40, 30
    tab, codes = write_tables(rs, n_ep, n_sel, hist_size)
    t_port, t_jax = basisu.decode_tables(tab), j_basisu.decode_tables(tab)
    assert t_port["hist_size"] == t_jax["hist_size"] == hist_size
    for k in ("ep_pred", "delta_ep", "sel", "rle"):
        np.testing.assert_array_equal(t_port[k].lut_sym, t_jax[k].lut_sym)
        np.testing.assert_array_equal(t_port[k].lut_len, t_jax[k].lut_len)
    for nbx, nby in ((9, 7), (16, 16), (1, 5)):
        payload = write_slice(rs, nbx, nby, n_ep, n_sel, hist_size, codes)
        got = basisu.decode_slice(payload, nbx, nby, n_ep, n_sel, t_port)
        want = j_basisu.decode_slice(payload, nbx, nby, n_ep, n_sel, t_jax)
        for a, b in zip(got, want):
            _same(a, b)
        assert got[0].max() < n_ep and got[1].max() < n_sel


def test_reconstruct_matches_jax():
    rs = np.random.RandomState(5)
    endpoints = np.concatenate([rs.randint(0, 32, (20, 3)), rs.randint(0, 8, (20, 1))], 1)
    selectors = rs.randint(0, 256, (15, 4)).astype(np.uint8)
    ep_idx = rs.randint(0, 20, (3, 4))
    sel_idx = rs.randint(0, 15, (3, 4))
    for lw, lh in ((16, 12), (13, 9)):
        _same(basisu._reconstruct(ep_idx, sel_idx, endpoints.astype(np.int32), selectors, lw, lh),
              j_basisu._reconstruct(ep_idx, sel_idx, endpoints.astype(np.int32), selectors,
                                    lw, lh))


def etc1s_ktx2(rs, w, h, levels, alpha_levels=(), hist_size=32, n_ep=24, n_sel=20):
    """A whole BasisLZ / ETC1S KTX2 file: DFD colour model 163, the global
    data (codebooks, tables, an image descriptor a level) and a random RGB
    slice a level, with an alpha slice on `alpha_levels`."""
    ep_data, _ = write_endpoints(rs, n_ep)
    sel_data, _ = write_selectors(rs, n_sel)
    tab_data, codes = write_tables(rs, n_ep, n_sel, hist_size)
    payloads, descs = [], []
    for lv in range(levels):
        lw, lh = max(w >> lv, 1), max(h >> lv, 1)
        nbx, nby = (lw + 3) // 4, (lh + 3) // 4
        rgb = write_slice(rs, nbx, nby, n_ep, n_sel, hist_size, codes)
        a = write_slice(rs, nbx, nby, n_ep, n_sel, hist_size, codes) if lv in alpha_levels else b""
        payloads.append(rgb + a)
        descs.append((0, 0, len(rgb), len(rgb) if a else 0, len(a)))
    sgd = struct.pack("<2H4I", n_ep, n_sel, len(ep_data), len(sel_data), len(tab_data), 0)
    sgd += b"".join(struct.pack("<5I", *d) for d in descs) + ep_data + sel_data + tab_data
    dfd = bytes(12) + bytes([163]) + bytes(31)
    return ktx2_bytes(0, w, h, payloads, scheme=1, dfd=dfd, sgd=sgd)


@pytest.mark.parametrize("size,levels,alpha", [((16, 16), 2, (0,)), ((13, 9), 3, (1,)),
                                               ((1024, 8), 2, ())])
def test_transcode_ktx2_matches_jax(size, levels, alpha):
    rs = np.random.RandomState(size[0])
    data = etc1s_ktx2(rs, *size, levels, alpha)
    p_port, p_jax = basisu.parse_basis_ktx2(data), j_basisu.parse_basis_ktx2(data)
    assert {k: v for k, v in p_port.items() if k != "data"} == \
        {k: v for k, v in p_jax.items() if k != "data"}
    for max_size in (0, 4, 512):
        got = basisu.transcode_ktx2(data, max_size=max_size)
        _same(got, j_basisu.transcode_ktx2(data, max_size=max_size))
        assert got is not None and got.shape[2] == 4
        if 0 not in alpha and got.shape[:2] == (size[1], size[0]):
            assert (got[..., 3] == 255).all()
    # decode_ktx2 routes BasisLZ to the transcoder at the atlas size
    _same(ktx2.decode_ktx2(data), j_ktx2.decode_ktx2(data))
    # level 0's slice cut short is None on both sides
    off, length, _ = p_port["level_index"][0]
    cut = data[:off + length - 3]
    assert basisu.transcode_ktx2(cut) is None and j_basisu.transcode_ktx2(cut) is None
