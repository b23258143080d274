"""The chunk coder's placement arithmetic (csrc/chunk.cuh), built for the
host with g++ and held against the reference's compositions.

The select kernel (B6, csrc/lossless.cu) puts chunk c of a row at
[off, off + len) and its 512 - len empty slots as zeros at
`zero_start(cap, c, off, len)`, and ORs its 2-bit code into
`header_word(c)` at `header_shift(c)`; the expand kernel (B7) reads them
back.  `tests/cuda_host/chunk_host.cpp` walks one row with those helpers
as the kernels do.  Shown here: for every code sequence of rows of 1-5
chunks the ranges cover [0, cap) exactly once and give
`codec.compact_chunk_rows`'s payload and length; the header bits equal
`codec.pack_word_rows(codes, 2)`; the read-back equals
`codec.gather_chunk_rows`, a short plane's clipped reads included.
"""
import ctypes
import itertools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import codec as C
from repro_torch.kernels import lossless as TL

HOST = Path(__file__).resolve().parent / "cuda_host"
CSRC = Path(TL.__file__).resolve().parent / "csrc"
RNG = np.random.default_rng(1126)
_P, _LL = ctypes.c_void_p, ctypes.c_longlong


@pytest.fixture(scope="module")
def place_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build csrc/chunk.cuh for the host")
    tmp = tmp_path_factory.mktemp("chunk_host")
    subprocess.run(["g++", "-std=c++17", "-O1", "-fPIC", "-shared", "-w",
                    "-I", str(HOST), "-I", str(CSRC), "-o",
                    str(tmp / "chunk.so"), str(HOST / "chunk_host.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(tmp / "chunk.so"))
    lib.place_row.argtypes = [_P, _P, _LL, _P, _P, _P]
    lib.place_row.restype = _LL
    lib.gather_row.argtypes = [_P, _P, _LL, _LL, _P]
    lib.gather_row.restype = None
    lib.code_of.argtypes = [ctypes.c_uint32, ctypes.c_int]
    lib.code_of.restype = ctypes.c_uint32
    lib.header_words_of.argtypes = [_LL]
    lib.header_words_of.restype = _LL
    return lib


def _image(codes):
    """A chunk image for `codes`: each chunk's used words random (nonzero,
    bit 31 set in some), the rest zero, as B5 writes it."""
    nc = len(codes)
    img = np.zeros((nc, C.LC_CHUNK), np.uint32)
    for c, k in enumerate(codes):
        n = C._LC_LENS[k]
        img[c, :n] = RNG.integers(1, 1 << 32, n, dtype=np.uint64)
    return img.reshape(-1)


def _place(lib, img, codes):
    nc = len(codes)
    cap = nc * C.LC_CHUNK
    payload = np.full(cap, 0xA5A5A5A5, np.uint32)
    writes = np.zeros(cap, np.int32)
    header = np.zeros(lib.header_words_of(nc), np.uint32)
    codes32 = np.asarray(codes, np.int32)
    plen = lib.place_row(img.ctypes.data, codes32.ctypes.data, nc,
                         payload.ctypes.data, writes.ctypes.data,
                         header.ctypes.data)
    return payload, writes, header, plen


def _reference(img, codes):
    codes_t = torch.from_numpy(np.asarray(codes, np.int32)[None])
    payload, plen = C.compact_chunk_rows(
        torch.from_numpy(img.view(np.int32)).reshape(1, len(codes),
                                                     C.LC_CHUNK),
        C.lc_chunk_lens(codes_t))
    return payload[0].numpy().view(np.uint32), int(plen[0]), \
        C.pack_word_rows(codes_t, 2)[0].numpy().view(np.uint32)


@pytest.mark.parametrize("nc", [1, 2, 3, 4, 5])
def test_ranges_tile_the_payload_once(place_lib, nc):
    """Every code sequence of nc chunks: each payload word written exactly
    once, the payload, its zero tail and its length equal to
    compact_chunk_rows', the header to pack_word_rows(codes, 2)."""
    for codes in itertools.product(range(4), repeat=nc):
        img = _image(codes)
        payload, writes, header, plen = _place(place_lib, img, codes)
        assert plen >= 0, (codes, plen)
        assert (writes == 1).all(), codes
        want, want_len, want_hdr = _reference(img, codes)
        assert plen == want_len, codes
        np.testing.assert_array_equal(payload, want, err_msg=str(codes))
        np.testing.assert_array_equal(header, want_hdr, err_msg=str(codes))


@pytest.mark.parametrize("nc", [2047, 2048, 2049, 5000])
def test_header_words_and_bits_match_pack_word_rows(place_lib, nc):
    """Rows past one tile of 16 x 128 codes: the header word and shift of
    every chunk and the plane's width agree with pack_word_rows."""
    codes = RNG.integers(0, 4, nc)
    img = _image(codes)
    payload, writes, header, plen = _place(place_lib, img, codes)
    want, want_len, want_hdr = _reference(img, codes)
    assert place_lib.header_words_of(nc) == C.lc_header_words(
        nc * C.LC_CHUNK) == want_hdr.shape[0]
    np.testing.assert_array_equal(header, want_hdr)
    assert (writes == 1).all() and plen == want_len
    np.testing.assert_array_equal(payload, want)


@pytest.mark.parametrize("cut", [None, 1, 129, 700, 1500])
def test_gather_reads_back_and_clips(place_lib, cut):
    """The expand's reads: each chunk's code from its header word, its
    words from [off, off + len), a source index past the plane clipped to
    its last word, slots past the length 0 — gather_chunk_rows, on the
    full plane and on planes cut to fewer words than the chunks need."""
    for codes in ((3, 1, 0, 2, 3), (0, 0, 0), (3, 3, 3, 3), (1, 2, 3, 1)):
        nc = len(codes)
        img = _image(codes)
        payload, _, header, _ = _place(place_lib, img, codes)
        if cut is not None:
            payload = payload[:cut].copy()
        out = np.zeros(nc * C.LC_CHUNK, np.uint32)
        place_lib.gather_row(header.ctypes.data, payload.ctypes.data,
                             payload.shape[0], nc, out.ctypes.data)
        codes_t = torch.from_numpy(np.asarray(codes, np.int32)[None])
        want = C.gather_chunk_rows(
            torch.from_numpy(payload.view(np.int32))[None],
            C.lc_chunk_lens(codes_t))
        np.testing.assert_array_equal(
            out, want.reshape(-1).numpy().view(np.uint32), err_msg=str(codes))
        if cut is None:
            np.testing.assert_array_equal(out, img)


def test_chunk_code_matches_lc_chunk_codes(place_lib):
    """chunk_code on a chunk's unsigned max against lc_chunk_codes, at
    the thresholds and with bit 31 set, both stages."""
    for mx in (0, 1, 255, 256, 65535, 65536, 2 ** 31 - 1, 2 ** 31,
               2 ** 32 - 1):
        chunk = torch.zeros(1, C.LC_CHUNK, dtype=torch.int64)
        chunk[0, 7] = mx
        chunk = C.to_i32(chunk)
        for narrow, stage in ((0, "zero"), (1, "narrow")):
            assert place_lib.code_of(mx, narrow) == int(
                C.lc_chunk_codes(chunk, stage)[0]), (mx, stage)
